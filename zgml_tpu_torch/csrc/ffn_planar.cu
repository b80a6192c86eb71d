// K6b fused_ffn: y = down(silu(gate(h)) * up(h)) for M <= 32 rows of an
// already-normed h, Q4_0 weights, no residual, in one launch.
//
// Replaces: zgml_tpu/ops/ffn.py `_ffn_q4_kernel` (pallas_call at line 224,
// entry `fused_ffn_pallas` -> `_ffn_impl`'s Q4_0 branch, ffn.py:636-668),
// which the JAX package's `_layer_step` runs through dispatch.fused_ffn
// (dispatch.py:95-110) for the FFN of every call of <= 32 rows where
// ffn_compatible holds: prefill chunks of up to 32 tokens (any prompt
// shorter than 33 tokens), batch > 1 decode, decode with ZGML_TPU_ATTN_BLOCK=0
// (models/llama.py:326-340). The caller norms h and adds the residual, as
// there. The JAX kernel reads the planar K-half-split copy of the weights;
// this one reads the port's one resident copy, w_gate_up [2F, D] (gate rows,
// then up rows) and w_down [D, F], N-major GGUF blocks (quant/packed.py).
//
// Semantics (the plain version is ops/ffn.py fused_ffn_ref): per row m,
// act[f] = (gate_f * sigmoid(gate_f)) * up_f with gate_f = h . dequant(W_gate[f]),
// up_f = h . dequant(W_up[f]); y[j] = sum_f act[f] * dequant(W_down[j, f]); f32
// operands, products as two TF32 parts (below).
//
// What bounds it on the H100: the weight bytes, 3 D F * 0.5625 (76.1 MB at
// Llama-2-7B, 19.5 MB at TinyLlama-1.1B), read once for all M rows, and its
// 6 M D F operations (run twice on the TF32 tensor cores, x split in two
// parts): bytes below ~20 rows.
//
// What the design does about it: two forms, chosen by rows in the wrapper
// (ops/ffn.py PLANAR_F32_MAX_M), both on weight_stream.cuh's producer (one
// persistent block an SM, 16 consumer warps and a producer warp filling a
// ring of slots) and `ws::CountBarrier` between the two phases. Up to 4 rows
// the CUDA-core form (ffn_planar_f32_kernel, below) streams whole row runs as
// K6d does. Above, the tensor-core form (the plan of ops/decode_plan.py
// planar_plan): a tile is 16 weight rows (gate|up: 8 gate rows and the same
// 8 up rows, so SwiGLU stays in the block; down: 16 rows), a stage its next
// `ks` quant blocks, whose 32 row pieces (qs and scales) the producer's lanes
// copy with cp.async, every weight byte once for all M rows. The contraction
// goes in chunks of `kc` blocks: per chunk the consumers stage that chunk of
// all M input rows once, split into TF32 hi = rna(x) and lo = rna(x - hi)
// (tf32_mma.cuh split_tf32): h's first chunk from the producer's bulk copy,
// the others from global behind a gate (`ws::Gate`'s rule: the producer
// copies at most `ahead` stages past the last chunk the consumers staged,
// since a load an SM issues waits behind the copies it has in flight). The
// 16 warps split as n8 tiles of the M rows x parts of a stage's blocks: per
// quant block 8 `mma.sync.m16n8k8` TF32 (the 16 rows' levels q - 8, exact in
// TF32, as A; the warp's n8 tile of x as B), the lo and the hi products in two
// fresh accumulators, added and joined to the warp's running sum by one fma
// with the row's scale. Per tile and chunk the parts' sums are added in part
// order (no float atomics: two launches give the same bits), into a per-tile
// sum across chunks in shared memory; after the last chunk gate|up writes act
// = silu(gate) * up to a global scratch and down writes y.
#include "weight_stream.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int PT_ROWS = 16;     // weight rows a tile: the A operand of m16n8k8
constexpr int PT_ROW_PAD = 16;  // bytes after each row's qs in a slot: word r (4 ks + 4) + t, so
                                // the 8 rows of a fragment load hit 32 distinct banks
constexpr int PT_XPAD = 16;     // floats after each staged x row (row m's B loads and row m + 1's
                                // fall in the other half of the banks)
constexpr int PT_X_BLOCKS = 512; // M * kc at most (ops/decode_plan.py PLANAR_X_FLOATS / 32)
constexpr int PT_RAW = 5;       // float4s of x a thread holds in the in-place split's second
                                // half: M * ceil(kc / 2) * 8 / 512 with M * kc <= 512

struct PlanarParams {
  const float* h;          // [M, D], normed, 16-byte aligned
  const uint8_t* gu_qs;    // [2F, D/32 * 16]
  const __half* gu_d;      // [2F, D/32]
  const uint8_t* dn_qs;    // [D, F/32 * 16]
  const __half* dn_d;      // [D, F/32]
  float* y;                // [M, D]
  float* act;              // [M, F] scratch
  unsigned int* bar;       // coop.barrier_words: [2..4] the CountBarrier's
  int M, D, F;
};

// The plan's ints (ops/decode_plan.py planar_ints) and the area offsets.
struct PlanarArgs {
  ws::Ring ring;           // stages, slot_bytes, x_off (the areas after the ring), ahead
  int part_off, acc_off, ks, kc;
};

// One weight of the launch as a block sees it: rows of nblk quant blocks,
// tiles of 16 rows (segs 2: rows 8t.. and the same rows + seg_off), this
// block's tiles [t0, t1), chunks of kc blocks.
struct PPhase {
  const uint8_t* qs;
  const __half* d;
  int nblk, segs, seg_off, t0, t1, nc;
};

__device__ __forceinline__ PPhase make_phase(const uint8_t* qs, const __half* d, int k, int segs,
                                             int seg_off, int n_rows, int kc) {
  const int tiles = n_rows / PT_ROWS;
  const int t0 = (int)(blockIdx.x * tiles / gridDim.x);     // 32-bit: tiles < 2^31 / 1024
  const int t1 = (int)((blockIdx.x + 1) * tiles / gridDim.x);
  const int nblk = k / 32;
  return PPhase{qs, d, nblk, segs, seg_off, t0, t1, (nblk + kc - 1) / kc};
}

// Weight row of slot row r of tile t.
__device__ __forceinline__ int tile_row(const PPhase& ph, int t, int r) {
  const int per = PT_ROWS / ph.segs;
  return t * per + r % per + (r / per) * ph.seg_off;
}

// Blocks and stages of chunk c.
__device__ __forceinline__ int chunk_blocks(const PPhase& ph, int c, int kc) {
  return min(kc, ph.nblk - c * kc);
}
// Stages of chunks 0..c of the block's tiles.
__device__ __forceinline__ int stages_through(const PPhase& ph, int c, int kc, int ks) {
  if (c < 0 || ph.t1 == ph.t0) return 0;
  const int full = min(c + 1, ph.nc - 1);
  const int last = c >= ph.nc - 1 ? (chunk_blocks(ph, ph.nc - 1, kc) + ks - 1) / ks : 0;
  return (ph.t1 - ph.t0) * (full * (kc / ks) + last);
}

// Scales of a stage as copied: 16 rows of `ks` (nblk % 8 == 0), else the
// tile's whole scale rows (a row's scale row is then not 16-byte aligned).
__device__ __forceinline__ bool whole_scales(const PPhase& ph) { return ph.nblk % 8 != 0; }

// The producer's gate over chunks numbered through both phases (gate|up's,
// then down's): stage n may be copied once n < end(g - 1) + ahead, g the
// consumers' count of staged chunks (1 at entry: the first chunk is the
// producer's own copy of h).
struct ChunkGate {
  int seen, limit;
  __device__ __forceinline__ int end(const PPhase (&ph)[2], int j, int kc, int ks) const {
    return j < ph[0].nc ? stages_through(ph[0], j, kc, ks)
                        : stages_through(ph[0], ph[0].nc - 1, kc, ks) +
                              stages_through(ph[1], j - ph[0].nc, kc, ks);
  }
  __device__ __forceinline__ void wait(const volatile unsigned* go, const PPhase (&ph)[2], int n,
                                       int kc, int ks, int ahead) {
    while (n >= limit) {
      const int g = (int)*go;
      if (g != seen) {
        seen = g;
        limit = end(ph, g - 1, kc, ks) + ahead;
      } else {
        __nanosleep(64);
      }
    }
  }
};

// The producer warp's copies of one phase, stage n of the launch into slot n
// % stages, in the consumers' order: chunk by chunk, tile by tile. A stage's
// rows are not contiguous (16 rows of a chunk of ks blocks), so the 32 lanes
// copy it in 16-byte pieces with cp.async, and each lane's cp.async arrival
// on the slot's full barrier (count 32) lands once its pieces have. A stage
// costs as much this way as by 32 bulk copies (one a row piece and one a
// scale row; PERF.md).
__device__ __forceinline__ void produce_phase(uint8_t* smem, const PlanarArgs& a,
                                              const PPhase (&ph)[2], const PPhase& f,
                                              ChunkGate& gate, int& n) {
  const int lane = threadIdx.x & 31;
  const int ks = a.ks, kc = a.kc;
  const volatile unsigned* go = ws::go_count(smem);
  const int rstride = ks * 16 + PT_ROW_PAD;
  const bool whole = whole_scales(f);
  const int per = PT_ROWS / f.segs;
  const size_t rq = (size_t)f.nblk * 16;
  for (int c = 0; c < f.nc; ++c) {
    const int c0 = c * kc, c1 = c0 + chunk_blocks(f, c, kc);
    for (int t = f.t0; t < f.t1; ++t)
      for (int s0 = c0; s0 < c1; s0 += ks) {
        const int nb = min(ks, c1 - s0);
        if (lane == 0) gate.wait(go, ph, n, kc, ks, a.ring.ahead);
        __syncwarp();
        const int slot = n % a.ring.stages;
        ws::mbar_wait(ws::empty_bar(smem, slot), ((n / a.ring.stages) & 1) ^ 1);
        uint8_t* dst = smem + ws::HEADER_BYTES + (size_t)slot * a.ring.slot_bytes;
        for (int i = lane; i < PT_ROWS * nb; i += 32) {      // qs: row i / nb, block i % nb
          const int r = i / nb, b = i % nb;
          tf32::cp_async16(dst + r * rstride + b * 16,
                           f.qs + (size_t)tile_row(f, t, r) * rq + (size_t)(s0 + b) * 16, true);
        }
        uint8_t* sd = dst + PT_ROWS * rstride;
        if (!whole) {                                         // 16 rows of nb scales
          const int q = nb / 8;
          for (int i = lane; i < PT_ROWS * q; i += 32) {
            const int r = i / q, e = i % q;
            tf32::cp_async16(sd + r * ks * 2 + e * 16,
                             f.d + (size_t)tile_row(f, t, r) * f.nblk + s0 + 8 * e, true);
          }
        } else {                                              // the tile's whole scale rows
          const int q = per * f.nblk / 8;                     // a segment's 16-byte pieces
          for (int i = lane; i < f.segs * q; i += 32) {
            const int sg = i / q, e = i % q;
            tf32::cp_async16(sd + sg * per * f.nblk * 2 + e * 16,
                             f.d + (size_t)tile_row(f, t, sg * per) * f.nblk + 8 * e, true);
          }
        }
        asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                         ws::smem_u32(ws::full_bar(smem, slot)))
                     : "memory");
        ++n;
      }
  }
}

// The producer warp: h's first chunk (each row's blocks into the upper half
// of its staged row, where the consumers split it in place), then both
// phases' stages.
__device__ __forceinline__ void produce_all(uint8_t* smem, const PlanarArgs& a,
                                            const PPhase (&ph)[2], const PlanarParams& p,
                                            float* xs, int xrow, bool copy_x) {
  const int lane = threadIdx.x & 31;
  if (copy_x) {
    const uint32_t bytes = (uint32_t)chunk_blocks(ph[0], 0, a.kc) * 128;
    if (lane == 0) ws::mbar_expect_tx(ws::x_bar(smem), bytes * p.M);
    __syncwarp();
    for (int m = lane; m < p.M; m += 32)
      ws::bulk_copy(xs + (size_t)m * xrow + a.kc * 32, p.h + (size_t)m * p.D, bytes,
                    ws::x_bar(smem));
  }
  ChunkGate gate{1, 0};
  gate.limit = gate.end(ph, 0, a.kc, a.ks) + a.ring.ahead;
  int n = 0;
  produce_phase(smem, a, ph, ph[0], gate, n);
  produce_phase(smem, a, ph, ph[1], gate, n);
  if (lane == 0) ws::produce_tail(smem, a.ring, n);
}

// x chunk [c0, c0 + nb) of the M rows of src (row stride K) -> xs: per row m
// and block b, 32 hi floats then 32 lo floats in element order (row stride
// xrow). src written in this launch is read with __ldcg.
__device__ __forceinline__ void split_block(float4 v, float* dst) {
  float4 hi, lo;
  uint32_t h, l;
  tf32::split_tf32(v.x, h, l); hi.x = __uint_as_float(h); lo.x = __uint_as_float(l);
  tf32::split_tf32(v.y, h, l); hi.y = __uint_as_float(h); lo.y = __uint_as_float(l);
  tf32::split_tf32(v.z, h, l); hi.z = __uint_as_float(h); lo.z = __uint_as_float(l);
  tf32::split_tf32(v.w, h, l); hi.w = __uint_as_float(h); lo.w = __uint_as_float(l);
  *reinterpret_cast<float4*>(dst) = hi;
  *reinterpret_cast<float4*>(dst + 32) = lo;
}

__device__ __forceinline__ void stage_x(const float* src, int K, int M, int c0, int nb, float* xs,
                                        int xrow) {
  const int per_row = nb * 8;                     // float4s a row
  for (int i = threadIdx.x; i < M * per_row; i += ws::CONSUMERS) {
    const int m = i / per_row, q = i % per_row;   // q: block q / 8, quad q % 8
    split_block(__ldcg(reinterpret_cast<const float4*>(src + (size_t)m * K + c0 * 32) + q),
                xs + (size_t)m * xrow + (q >> 3) * 64 + (q & 7) * 4);
  }
}

// The same from the producer's raw copy of the chunk in the upper half of
// each staged row. Output block b covers raw blocks 2b - kc and 2b - kc + 1
// (raw block b' lies at kc * 32 + 32 b'), so the outputs of blocks b <
// nb / 2 <= kc / 2 cover none and are written as they are read; the rest are
// read whole before any of them is written.
__device__ __forceinline__ void split_x_in_place(int M, int nb, int kc, float* xs, int xrow) {
  const int hb = nb / 2;
  for (int i = threadIdx.x; i < M * hb * 8; i += ws::CONSUMERS) {
    const int m = i / (hb * 8), q = i % (hb * 8);
    float* row = xs + (size_t)m * xrow;
    split_block(*reinterpret_cast<const float4*>(row + kc * 32 + q * 4),
                row + (q >> 3) * 64 + (q & 7) * 4);
  }
  const int per_row = (nb - hb) * 8;       // float4s a row in the second half
  float4 raw[PT_RAW];
#pragma unroll
  for (int u = 0; u < PT_RAW; ++u) {
    const int i = threadIdx.x + u * ws::CONSUMERS;
    if (i < M * per_row)
      raw[u] = *reinterpret_cast<const float4*>(xs + (size_t)(i / per_row) * xrow + kc * 32 +
                                                hb * 32 + (i % per_row) * 4);
  }
  ws::sync();
#pragma unroll
  for (int u = 0; u < PT_RAW; ++u) {
    const int i = threadIdx.x + u * ws::CONSUMERS;
    if (i < M * per_row) {
      const int q = hb * 8 + i % per_row;
      split_block(raw[u], xs + (size_t)(i / per_row) * xrow + (q >> 3) * 64 + (q & 7) * 4);
    }
  }
}

// Level of byte S of a word of nibbles (0x0F0F0F0F-masked), as TF32 bits.
template <int S>
__device__ __forceinline__ uint32_t level_bits(uint32_t nib) {
  return __float_as_uint(ws::byte_float<S>(nib) - 8388616.f);
}

// One quant block of a landed stage for this warp: rows g and g + 8 of the
// tile (word t of the block: element 4t + s in byte s's low nibble, 16 + 4t
// + s in its high one, k-step s taking both), against the warp's n8 tile of
// the staged x block, row m of it at x (null past M). k-step s's A columns t
// and t + 4 are elements 4t + s and 16 + 4t + s, and so are its B rows. The
// lo and the hi products go into two fresh accumulators (two chains of 4
// MMAs, issued in turn), joined by one add, then run += scale * block.
__device__ __forceinline__ void block_mma(uint32_t w0, uint32_t w1, float s0, float s1,
                                          const float* x, float (&run)[4]) {
  const uint32_t lo0 = w0 & 0x0F0F0F0Fu, hi0 = (w0 >> 4) & 0x0F0F0F0Fu;
  const uint32_t lo1 = w1 & 0x0F0F0F0Fu, hi1 = (w1 >> 4) & 0x0F0F0F0Fu;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 la = x ? *reinterpret_cast<const float4*>(x + 32) : zero;
  const float4 lb = x ? *reinterpret_cast<const float4*>(x + 48) : zero;
  const float4 ha = x ? *reinterpret_cast<const float4*>(x) : zero;
  const float4 hb = x ? *reinterpret_cast<const float4*>(x + 16) : zero;
  float cl[4] = {0.f, 0.f, 0.f, 0.f}, ch[4] = {0.f, 0.f, 0.f, 0.f};
  {
    const uint32_t a[4] = {level_bits<0>(lo0), level_bits<0>(lo1), level_bits<0>(hi0),
                           level_bits<0>(hi1)};
    tf32::mma_tf32(cl, a, __float_as_uint(la.x), __float_as_uint(lb.x));
    tf32::mma_tf32(ch, a, __float_as_uint(ha.x), __float_as_uint(hb.x));
  }
  {
    const uint32_t a[4] = {level_bits<1>(lo0), level_bits<1>(lo1), level_bits<1>(hi0),
                           level_bits<1>(hi1)};
    tf32::mma_tf32(cl, a, __float_as_uint(la.y), __float_as_uint(lb.y));
    tf32::mma_tf32(ch, a, __float_as_uint(ha.y), __float_as_uint(hb.y));
  }
  {
    const uint32_t a[4] = {level_bits<2>(lo0), level_bits<2>(lo1), level_bits<2>(hi0),
                           level_bits<2>(hi1)};
    tf32::mma_tf32(cl, a, __float_as_uint(la.z), __float_as_uint(lb.z));
    tf32::mma_tf32(ch, a, __float_as_uint(ha.z), __float_as_uint(hb.z));
  }
  {
    const uint32_t a[4] = {level_bits<3>(lo0), level_bits<3>(lo1), level_bits<3>(hi0),
                           level_bits<3>(hi1)};
    tf32::mma_tf32(cl, a, __float_as_uint(la.w), __float_as_uint(lb.w));
    tf32::mma_tf32(ch, a, __float_as_uint(ha.w), __float_as_uint(hb.w));
  }
  const float acc[4] = {__fadd_rn(cl[0], ch[0]), __fadd_rn(cl[1], ch[1]),
                        __fadd_rn(cl[2], ch[2]), __fadd_rn(cl[3], ch[3])};
  run[0] = fmaf(s0, acc[0], run[0]);
  run[1] = fmaf(s0, acc[1], run[1]);
  run[2] = fmaf(s1, acc[2], run[2]);
  run[3] = fmaf(s1, acc[3], run[3]);
}

// The consumers over one phase: per chunk, stage x, then each tile's stages,
// then the tile's sum over the warps (in part order) into its running sum
// over chunks (acc) and, after the last chunk, out (gate|up: SwiGLU into
// act; down: y). j counts the launch's chunks (the gate's numbering). The 16
// warps split as nt n8 tiles of the M rows (ceil(M / 8), rounded up to 1, 2
// or 4) times 16 / nt parts: warp w takes n8 tile w / parts and blocks w %
// parts, w % parts + parts, ... of each stage.
template <bool DOWN>
__device__ __forceinline__ void consume_phase(uint8_t* smem, const PlanarArgs& a, const PPhase& f,
                                              const PlanarParams& p, const float* src, int K,
                                              float* out, int ld_out, int& n, int& j,
                                              bool first_copied) {
  if (f.t1 == f.t0) {                      // no tiles here: nothing staged, nothing released
    j += f.nc;
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ks = a.ks, kc = a.kc, M = p.M;
  const int parts = M <= 8 ? 16 : M <= 16 ? 8 : 4;
  const int kp = warp % parts, m = (warp / parts) * 8 + g;   // this lane's B row
  float* xs = reinterpret_cast<float*>(smem + a.ring.act_off);
  const int xrow = kc * 64 + PT_XPAD;
  float* part = reinterpret_cast<float*>(smem + a.part_off);   // [warp][16 rows][8]
  float* acc = reinterpret_cast<float*>(smem + a.acc_off);
  const bool whole = whole_scales(f);
  const int rstride = ks * 16 + PT_ROW_PAD;
  const int sstride = whole ? f.nblk : ks;
  const int outs = (DOWN ? PT_ROWS : PT_ROWS / 2) * M;   // one thread an output
  for (int c = 0; c < f.nc; ++c, ++j) {
    const int c0 = c * kc, nbc = chunk_blocks(f, c, kc);
    if (c == 0 && first_copied) {
      ws::mbar_wait(ws::x_bar(smem), 0);
      split_x_in_place(M, nbc, kc, xs, xrow);
      ws::sync();
    } else {
      stage_x(src, K, M, c0, nbc, xs, xrow);
      ws::release(smem, j);
    }
    const float* xm = m < M ? xs + m * xrow + 4 * t : nullptr;
    for (int tt = f.t0; tt < f.t1; ++tt) {
      float run[4] = {0.f, 0.f, 0.f, 0.f};
      for (int s0 = 0; s0 < nbc; s0 += ks) {
        const int nb = min(ks, nbc - s0);
        const int slot = n % a.ring.stages;
        ws::mbar_wait(ws::full_bar(smem, slot), (n / a.ring.stages) & 1);
        const uint8_t* st = smem + ws::HEADER_BYTES + (size_t)slot * a.ring.slot_bytes;
        const __half* sc = reinterpret_cast<const __half*>(st + PT_ROWS * rstride) +
                           (whole ? c0 + s0 : 0);
#pragma unroll 1
        for (int b = kp; b < nb; b += parts) {
          const uint32_t w0 = *reinterpret_cast<const uint32_t*>(st + g * rstride + b * 16 + 4 * t);
          const uint32_t w1 =
              *reinterpret_cast<const uint32_t*>(st + (g + 8) * rstride + b * 16 + 4 * t);
          const float sc0 = __half2float(sc[g * sstride + b]);
          const float sc1 = __half2float(sc[(g + 8) * sstride + b]);
          block_mma(w0, w1, sc0, sc1, xm ? xm + (s0 + b) * 64 : nullptr, run);
        }
        __syncwarp();
        if (lane == 0) ws::mbar_arrive(ws::empty_bar(smem, slot));
        ++n;
      }
      // the warp's sums: C fragment rows g / g + 8, columns 2t, 2t + 1 of its n8 tile
      float* pr = part + (warp * PT_ROWS + g) * 8 + 2 * t;
      *reinterpret_cast<float2*>(pr) = make_float2(run[0], run[1]);
      *reinterpret_cast<float2*>(pr + 64) = make_float2(run[2], run[3]);
      ws::sync();
      if ((int)threadIdx.x < outs) {
        const int r = threadIdx.x / M, mo = threadIdx.x % M;
        const float* pm = part + ((mo >> 3) * parts * PT_ROWS + r) * 8 + (mo & 7);
        float v0 = 0.f, v1 = 0.f;
        for (int q = 0; q < parts; ++q) {
          v0 += pm[q * PT_ROWS * 8];
          if (!DOWN) v1 += pm[q * PT_ROWS * 8 + 64];
        }
        if (f.nc > 1) {                    // the tile's sum over chunks, in chunk order
          float* at = acc + (tt - f.t0) * PT_ROWS * M;
          if (c > 0) {
            v0 = at[r * M + mo] + v0;
            if (!DOWN) v1 = at[(r + 8) * M + mo] + v1;
          }
          at[r * M + mo] = v0;
          if (!DOWN) at[(r + 8) * M + mo] = v1;
        }
        if (c == f.nc - 1) {
          if constexpr (DOWN) {
            out[(size_t)mo * ld_out + tt * PT_ROWS + r] = v0;
          } else {
            out[(size_t)mo * ld_out + tt * (PT_ROWS / 2) + r] =
                (v0 * (1.0f / (1.0f + expf(-v0)))) * v1;
          }
        }
      }
      ws::sync();                          // part is rewritten by the next tile
    }
  }
}

__global__ void __launch_bounds__(ws::THREADS, 1) ffn_planar_kernel(PlanarParams p, PlanarArgs a) {
  extern __shared__ __align__(128) uint8_t smem[];
  if (threadIdx.x == 0) {                  // ws::ring_init, with a full barrier of 32 arrivals
    for (int sl = 0; sl < a.ring.stages; ++sl) {
      ws::mbar_init(ws::full_bar(smem, sl), 32);
      ws::mbar_init(ws::empty_bar(smem, sl), ws::WARPS);
    }
    ws::mbar_init(ws::x_bar(smem), 1);
    *ws::go_count(smem) = 1;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const PPhase gu = make_phase(p.gu_qs, p.gu_d, p.D, 2, p.F, 2 * p.F, a.kc);
  // h's first chunk is the producer's copy where the block has gate|up tiles
  const bool copy_x = gu.t1 > gu.t0;
  if (threadIdx.x >= ws::CONSUMERS) {      // the producer warp
    const PPhase ph[2] = {gu, make_phase(p.dn_qs, p.dn_d, p.F, 1, 0, p.D, a.kc)};
    produce_all(smem, a, ph, p, reinterpret_cast<float*>(smem + a.ring.act_off),
                a.kc * 64 + PT_XPAD, copy_x);
    return;
  }
  ws::CountBarrier gb;
  gb.start(p.bar + 2);
  int n = 0, j = 0;
  consume_phase<false>(smem, a, gu, p, p.h, p.D, p.act, p.F, n, j, copy_x);
  gb.wait();
  // down's tiles, made here: nothing of them stays live through gate|up
  consume_phase<true>(smem, a, make_phase(p.dn_qs, p.dn_d, p.F, 1, 0, p.D, a.kc), p, p.act, p.F,
                      p.y, p.D, n, j, false);
}

int launch(const PlanarParams& p, const int* plan, int device, cudaStream_t st) {
  static std::atomic<unsigned> ready{0};
  const int grid = plan[0], stages = plan[1], slot = plan[2], x_bytes = plan[3];
  const int part_bytes = plan[4], acc_bytes = plan[5], smem = plan[6], ks = plan[7], kc = plan[8];
  const int ahead = plan[9], max_tiles = plan[10];
  const int nblk_max = (p.D > p.F ? p.D : p.F) / 32;
  // a stage's scale row: ks blocks, or a phase's whole row where it is not a multiple of 8
  const int sd = p.D / 32 % 8 ? p.D / 32 : ks, sf = p.F / 32 % 8 ? p.F / 32 : ks;
  const int scale_rows = sd > sf ? sd : sf;
  const int tiles_max = (2 * p.F / PT_ROWS > p.D / PT_ROWS ? 2 * p.F / PT_ROWS : p.D / PT_ROWS);
  const bool chunked = nblk_max > kc;
  if (grid < 1 || stages < 1 || stages > ws::MAX_STAGES || slot % 128 != 0 || ks < 16 ||
      ks % 16 != 0 || kc < ks || kc % ks != 0 || p.M * kc > PT_X_BLOCKS ||
      slot < PT_ROWS * (ks * 16 + PT_ROW_PAD) + PT_ROWS * scale_rows * 2 ||
      (size_t)x_bytes < (size_t)p.M * (kc * 64 + PT_XPAD) * 4 ||
      part_bytes < ws::WARPS * PT_ROWS * 8 * 4 ||
      max_tiles < (tiles_max + grid - 1) / grid ||
      (chunked && acc_bytes < max_tiles * PT_ROWS * p.M * 4) || ahead < 1 ||
      smem != ws::HEADER_BYTES + stages * slot + x_bytes + part_bytes + acc_bytes ||
      smem > 232448)
    return ZGML_ERR_SMEM;
  const int x_off = ws::HEADER_BYTES + stages * slot;
  const PlanarArgs a{{stages, slot, x_off, ahead}, x_off + x_bytes, x_off + x_bytes + part_bytes,
                     ks, kc};
  return ws::launch(ffn_planar_kernel, p, a, grid, smem, device, ready, st);
}

// ---- the CUDA-core form, M <= 4 (ops/ffn.py PLANAR_F32_MAX_M) -----------------
//
// K6d's streaming and dots (csrc/ffn.cu, on K6d's plan ops/decode_plan.py
// ffn_plan) without its norm and residual: whole weight rows in big bulk
// copies, h's rows staged as f32 for the group of MR rows (the first group's
// copied by the producer ahead of the weights), `ws::dot_f32` (f32 FMAs,
// lane l on blocks l, l + 32, ..., the lanes' sums by the xor butterfly).
// Where the plan's group holds every row (all of M <= 4 at TinyLlama-1.1B,
// M <= 2 at Llama-2-7B) each weight byte is read once; at a few rows it is
// faster than the tensor-core form (PERF.md), whose stages of 16
// rows' K chunks take 32 copies each.
template <int MR>
__global__ void __launch_bounds__(ws::THREADS, 1) ffn_planar_f32_kernel(PlanarParams p,
                                                                          ws::Args a) {
  using F = FmtQ4_0;
  extern __shared__ __align__(128) uint8_t smem[];
  ws::ring_init(smem, a.ring);
  const int groups = (p.M + MR - 1) / MR;
  const int nbD = p.D / 32, nbF = p.F / 32;
  const int xs_row = nbD * ws::XPAD, xa_row = nbF * ws::XPAD;
  float* xin = reinterpret_cast<float*>(smem + a.ring.act_off) + MR * xs_row;
  const int rows0 = p.M < MR ? p.M : MR;
  if (threadIdx.x >= ws::CONSUMERS) {      // the producer warp: one thread copies
    if (threadIdx.x == ws::CONSUMERS) {
      ws::mbar_expect_tx(ws::x_bar(smem), rows0 * p.D * 4);
      ws::bulk_copy(xin, p.h, rows0 * p.D * 4, ws::x_bar(smem));
      int range[4], n = 0;
      ws::block_ranges<2>(a.ph, range);
      ws::Gate<2> gate;                    // w_down: `ahead` stages until act is staged
      for (int gi = 0; gi < groups; ++gi) {
        ws::produce<F>(smem, a.ring, a.ph[0], range[0], range[1], n, gate, gi > 0);
        if (gi == 0) gate.start(a.ph, range, a.ring.ahead);
        ws::produce<F>(smem, a.ring, a.ph[1], range[2], range[3], n, gate, true);
      }
      ws::produce_tail(smem, a.ring, n);
    }
    return;
  }
  ws::CountBarrier gb;
  gb.start(p.bar + 2);
  float* act = reinterpret_cast<float*>(smem + a.ring.act_off);
  const int lane = threadIdx.x & 31;
  constexpr int R = ws::ITEM_ROWS;
  int n = 0;
  for (int gi = 0; gi < groups; ++gi) {
    const int m0 = gi * MR, rows = p.M - m0 < MR ? p.M - m0 : MR;
    // 1. gate|up + SwiGLU on the group's rows (the first group's from the copy)
    if (gi == 0) ws::mbar_wait(ws::x_bar(smem), 0);
    for (int m = 0; m < MR; ++m) {         // rows past the group's end stay 0
      float* dst = act + m * xs_row;
      if (m < rows) {
        const float* src = gi == 0 ? xin + m * p.D : p.h + (size_t)(m0 + m) * p.D;
        for (int i = threadIdx.x; i < p.D; i += ws::CONSUMERS)
          dst[(i >> 5) * ws::XPAD + (i & 31)] = src[i];
      } else {
        ws::zero_words(reinterpret_cast<uint32_t*>(dst), xs_row);
      }
    }
    ws::sync();
    ws::consume<F, R>(smem, a.ring, a.ph[0], n, [&](const ws::StageView<F>& v, int i, int row) {
      int j[R], at[R];
      ws::item_rows<R>(v, i, j, at);
      float acc[R][MR];
      ws::dot_f32<F, R, MR>(v, j, act, xs_row, lane, acc);
#pragma unroll
      for (int r = 0; r < R; r += 2)       // (gate f, up f)
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          const float gate = warp_sum(acc[r][m]);
          const float up = warp_sum(acc[r + 1][m]);
          if (lane == 0 && m < rows)
            p.act[(size_t)(m0 + m) * p.F + row + at[r]] =
                (gate * (1.0f / (1.0f + expf(-gate)))) * up;
        }
    });
    gb.wait();
    // 2. down
    for (int m = 0; m < MR; ++m) {
      if (m < rows) {
        ws::stage_rows(p.act + (size_t)(m0 + m) * p.F, p.F, act + m * xa_row);
      } else {
        ws::zero_words(reinterpret_cast<uint32_t*>(act + m * xa_row), xa_row);
      }
    }
    ws::release(smem, 2 * gi + 2);
    ws::consume<F, R>(smem, a.ring, a.ph[1], n, [&](const ws::StageView<F>& v, int i, int row) {
      int j[R], at[R];
      ws::item_rows<R>(v, i, j, at);
      float acc[R][MR];
      ws::dot_f32<F, R, MR>(v, j, act, xa_row, lane, acc);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          const float sum = warp_sum(acc[r][m]);
          if (lane == 0 && m < rows) p.y[(size_t)(m0 + m) * p.D + row + at[r]] = sum;
        }
    });
    ws::sync();                            // the area is restaged for the next group
  }
}

// The f32 form on K6d's plan ints and device bounds (ops/decode_plan.py ffn_plan).
template <int MR>
int launch_f32(const PlanarParams& p, const int* plan, const int* bounds, int device,
               cudaStream_t st) {
  static std::atomic<unsigned> ready{0};
  const ws::Args a{{ws::plan_phase(plan, 0, p.gu_qs, p.gu_d, bounds, p.D),
                    ws::plan_phase(plan, 1, p.dn_qs, p.dn_d, bounds, p.F)},
                   {plan[1], plan[2], ws::HEADER_BYTES + plan[1] * plan[2], plan[7]}, nullptr};
  const size_t gu = (size_t)MR * p.D / 32 * ws::XPAD * 4 + (size_t)(p.M < MR ? p.M : MR) * p.D * 4;
  const size_t dn = (size_t)MR * p.F / 32 * ws::XPAD * 4;
  if (plan[5] != MR || plan[6] != 2 || a.ph[0].segs != 2 || a.ph[0].seg_off != p.F ||
      a.ph[1].segs != 1 || !ws::plan_fits<FmtQ4_0>(plan, a.ph, 2, gu > dn ? gu : dn))
    return ZGML_ERR_SMEM;
  return ws::launch(ffn_planar_f32_kernel<MR>, p, a, plan[0], plan[4], device, ready, st);
}

}  // namespace

// The CUDA-core form (M <= 4): as zgml_ffn, on K6d's plan (plan: its host
// ints, bounds: its int32 [2, grid + 1] range bounds on the card).
ZGML_EXPORT int zgml_ffn_f32(const float* h, const uint8_t* gu_qs, const void* gu_d,
                             const uint8_t* dn_qs, const void* dn_d, float* y, float* act,
                             unsigned int* bar, int M, int D, int F, const int* plan,
                             const int* bounds, int device, void* stream) {
  if (M <= 0 || M > 4 || D <= 0 || F <= 0 || D % 32 != 0 || F % 32 != 0 || plan == nullptr ||
      bounds == nullptr || !ws::aligned16(h) || !ws::aligned16(gu_d) || !ws::aligned16(dn_d))
    return ZGML_ERR_SHAPE;
  const PlanarParams p{h, gu_qs, static_cast<const __half*>(gu_d), dn_qs,
                       static_cast<const __half*>(dn_d), y, act, bar, M, D, F};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (plan[5]) {
    case 1: return launch_f32<1>(p, plan, bounds, device, st);
    case 2: return launch_f32<2>(p, plan, bounds, device, st);
    case 4: return launch_f32<4>(p, plan, bounds, device, st);
    default: return ZGML_ERR_SHAPE;
  }
}

// Q4_0 only (the JAX kernel's only kind; at Q8_0 the JAX package runs K6a):
// h f32 [M, D] (normed, 16-byte aligned), w_gate_up (qs [2F, D/2], d fp16
// [2F, D/32]), w_down (qs [D, F/2], d fp16 [D, F/32]), the planes 16-byte
// aligned -> y f32 [M, D]; act f32 [M, F] scratch; bar: the CountBarrier's
// words (coop.barrier_words); plan: ops/decode_plan.py planar_ints; device:
// the card's index. All contiguous.
ZGML_EXPORT int zgml_ffn(int kind, const float* h, const uint8_t* gu_qs, const void* gu_d,
                         const uint8_t* dn_qs, const void* dn_d, float* y, float* act,
                         unsigned int* bar, int M, int D, int F, const int* plan, int device,
                         void* stream) {
  if (M <= 0 || M > 32 || D <= 0 || F <= 0 || D % 32 != 0 || F % 32 != 0 || plan == nullptr ||
      !ws::aligned16(h) || !ws::aligned16(gu_qs) || !ws::aligned16(gu_d) ||
      !ws::aligned16(dn_qs) || !ws::aligned16(dn_d))
    return ZGML_ERR_SHAPE;
  if (kind != 0) return ZGML_ERR_KIND;
  const PlanarParams p{h, gu_qs, static_cast<const __half*>(gu_d), dn_qs,
                       static_cast<const __half*>(dn_d), y, act, bar, M, D, F};
  return launch(p, plan, device, static_cast<cudaStream_t>(stream));
}
