// K14 stack_decode / K15 tape_decode: one batch-1 decode token through every
// layer of a Llama stack in one launch, Q4_0 weights, a bf16 or an f32 cache.
// The kernel and its launcher, templated on the cache element C; the bf16
// instantiations and the exported launcher are stack_decode.cu's, the f32
// ones stack_decode_f32.cu's (a translation unit of their own, so nvcc
// compiles them beside it).
//
// Replaces: zgml_tpu/ops/stackkernel.py `_stack_kernel` (pallas_call at line
// 422, entry `stacked_decode_step`; BF16 false) and zgml_tpu/ops/tapekernel.py
// `_tape_kernel` (pallas_call at line 553, entry `tape_decode_step`; BF16
// true, or false under ZGML_TPU_TAPE_BF16=0). The JAX package reaches them
// from models/llama.py:753-771 when LlamaModel.enable_stacked_decode() /
// enable_tape_decode() attached their views and ZGML_TPU_STACK_DECODE /
// ZGML_TPU_TAPE_DECODE is on. Those views are copies of the weights laid out
// for the TPU (stacked [L, ...] tiles, one flat tape of 512-lane entries
// streamed through a hand-DMA'd VMEM window); here the kernel reads the
// port's one resident copy through a table of per-layer pointers
// (ops/stackkernel.py StackedLayers).
//
// Semantics (plain versions: ops/stackkernel.py stacked_decode_ref, ops/
// tapekernel.py tape_decode_ref): for l = 0 .. L-1, K7's function (f32 A
// phase, the cache's element) then K6d's at one row:
//   x2 = x + attn(rmsnorm(x) * g1) @ Wo^T, writing k_cur / v_cur of layer l
//        into cache row pos, rounded to bf16 over the bf16 cache and as they
//        are over the f32 one (phase B reads rows < pos only, in f32, so the
//        cache ends as the JAX package's, which writes all layers' rows
//        after the call cast to the cache's dtype: stackkernel.py:529-530,
//        tapekernel.py:590-593; its kernels read the cache through
//        .astype(jnp.float32), stackkernel.py:159, 173, tapekernel.py:359,
//        373);
//   x  = x2 + down(silu(gate(n)) * up(n)), n = rmsnorm(x2) * g2.
// K14 takes the f32 A phase whatever ZGML_TPU_ATTN_I8A says, as the JAX
// kernel does; with f32 operands it runs K7's and K6d's arithmetic in their
// order, so its bits are those of the per-layer chain (K7, then K6d at M 1)
// on the same inputs. With BF16 (K15, tapekernel.py _deq_rows and the
// `.astype(mxu)` calls at :319-323, 428-431, 451) every weight element is
// bf16_rn(level * bf16_rn(scale)) and the four staged operand rows (the normed
// x, att, the normed x2, the SwiGLU activation) are rounded to bf16 once;
// products are exact in f32 and summed in f32 (weight_stream.cuh dot_bf16);
// attention, norms and residuals stay f32.
//
// What bounds it on the H100: the weight bytes, read once per token (24.8 MB
// a layer at TinyLlama-1.1B at Q4_0, 545 MB for its 22 layers: ~163 us at
// 3.35 TB/s), plus the live cache rows (1 KB per position and layer at
// TinyLlama-1.1B over the bf16 cache, 2 KB over the f32 one); then its 5 L - 1 grid barriers, about 2 us each, which
// that bound does not count.
//
// What the design does about it (weight_stream.cuh, as K7 and K6): one
// persistent block an SM (the grid of ops/decode_plan.py stack_plan, launched
// cooperatively), 16 consumer warps and a producer warp. From kernel entry
// the producer copies x, layer 0's gain and the pointer table (where it fits
// beside two stages; else a layer's pointers are read from global memory at
// the layer's start), then streams
// every layer's four weights in order through one ring of shared-memory
// slots with 1D bulk copies (TMA): wqkv (phase A, in RoPE-pair runs), wo
// (C), w_gate_up (gate|up, in (gate row, up row) runs) and w_down (down),
// the same plan for every layer. It runs ahead across the grid barriers,
// which only the consumers pass, held by a Gate: at most `ahead` stages in
// flight past the last phase whose activations the consumers staged (a load,
// atomic or poll an SM issues queues behind its bulk copies in flight). A
// layer:
//   A  | B with the combine | C | gate|up | down | (the next layer's A)
// five grid barriers a layer, 5 L - 1 a token. Phase B and the combine are
// K7's (layer_phases.cuh phase_b_merged: the combine runs in the last block
// of each KV head, which merges the chunks in their fixed order and sets the
// head's count back to 0 for the next layer). Over the f32 cache it is K7's
// f32-cache phase B (decode_split.cuh: a chunk's K, then its V, staged in
// one buffer), so the activation area, and with it the plan, is the bf16
// cache's. Activations written in the
// launch (q, att, x2, act, the next layer's x) are read with __ldcg after the
// barrier; only layer 0's x and gain come by bulk copy. The layer's input x
// (then x2) stays in shared memory as a raw row for the residual. Head dims
// 32-256 with f32 operands, 64, 128 and 256 with bf16 ones (the JAX tape
// takes head dims dividing 512). No float atomics: two launches give the same
// bits.
#pragma once

#include "layer_phases.cuh"

// The launch's parameters over a cache of element C (__nv_bfloat16 or float):
// the cache pointers stay typed by the element.
template <class C>
struct StackParams {
  const unsigned long long* table;   // [L][T_SLOTS] device pointers
  const float* x;                    // [d]: layer 0's input
  const float* cos;                  // [hd/2] at pos
  const float* sin;
  C* ck;                             // [L, hkv, S, hd]
  C* cv;
  const int* pos;                    // [1], device
  float* x_out;                      // [d]
  float* kv_cur;                     // [L, 2, hkv, hd]: each layer's rotated k, then v
  float* q;                          // [hq, hd] scratch
  float* att;                        // [hq, hd] scratch
  float* part;                       // [hq, n_split, hd + 2] scratch
  float* x2;                         // [d] scratch: x + attention
  float* xres;                       // [d] scratch: the residual between layers
  float* act;                        // [F] scratch
  unsigned int* bar;                 // coop.barrier_words: [2..4] the CountBarrier's
  unsigned int* heads;               // hkv arrival words, left zeroed
  int L, d, hq, hkv, S, n_split, F;
  float eps, scale;
};

// The f32 cache's launcher (stack_decode_f32.cu): bf16_ops as the exported
// launcher's, hd the head dim.
int launch_stack_f32kv(const StackParams<float>& p, int bf16_ops, int hd, const int* plan,
                       const int* bounds, int device, cudaStream_t st);

namespace {

// Per-layer pointers, in the order of ops/stackkernel.py TABLE.
enum TableSlot : int {
  T_G1, T_G2, T_WQKV_QS, T_WQKV_D, T_WO_QS, T_WO_D, T_GU_QS, T_GU_D, T_DN_QS, T_DN_D, T_SLOTS
};
// A layer's phase kinds, in stream order; the table slot of each one's qs
// (its scales follow).
enum PhaseKind : int { PA, PC, PGU, PDN, KINDS };
__host__ __device__ constexpr int qs_slot(int k) { return T_WQKV_QS + 2 * k; }


// The streamed weights of a layer (their qs / d pointers come from the table),
// the ring, and where the table is read: staged in shared memory at the
// activation area's start (tab_smem), or, where that leaves no two stages
// (80 layers of the 70B width), each layer's row from global memory.
struct StackArgs {
  ws::Phase ph[KINDS];
  ws::Ring ring;
  int tab_smem;
};

// Bytes of the pointer table as copied, and as it sits in shared memory.
__host__ __device__ inline uint32_t table_bytes(int L) { return (uint32_t)L * T_SLOTS * 8; }
__host__ __device__ inline size_t table_area(int L) {
  return ((size_t)table_bytes(L) + 127) / 128 * 128;
}

// Bytes of the activation area (ops/decode_plan.py stack_act_bytes): the
// table where it is staged, a raw row of d floats, then the phases' area:
// A's normed x with layer 0's gain as copied behind it, B's chunk and an int
// for each of a block's `items`, C's staged attention, gate|up's normed x2,
// down's staged SwiGLU row.
template <int D>
size_t stack_act_bytes(int L, int d, int hq, int hkv, int F, int items, bool table) {
  const size_t row = (size_t)d / 32 * ws::XPAD * 4;
  size_t m = row + (size_t)d * 4;
  const size_t b = decode_chunk_smem_bytes<D, false>(hq / hkv) + (size_t)4 * items;
  const size_t c = (size_t)hq * D / 32 * ws::XPAD * 4;
  const size_t dn = (size_t)F / 32 * ws::XPAD * 4;
  if (b > m) m = b;
  if (c > m) m = c;
  if (dn > m) m = dn;
  return (table ? table_area(L) : 0) + (size_t)d * 4 + m;
}

template <class T>
__device__ __forceinline__ T* slot(const unsigned long long* row, int s) {
  return reinterpret_cast<T*>(row[s]);
}

// The producer (one thread): x, layer 0's gain and the table (where it is
// staged) first, then every layer's four weights through the ring, held by
// the gate. tab: the staged table, or the global one.
template <class C>
__device__ __forceinline__ void produce_stack(uint8_t* smem, const StackParams<C>& p,
                                              const StackArgs& a,
                                              const unsigned long long* tab, float* raw,
                                              float* g0) {
  using F = FmtQ4_0;
  const int* range = ws::ranges(smem);
  // layer 0's pointers come before any copy is in flight
  const float* g1 = reinterpret_cast<const float*>(__ldg(p.table + T_G1));
  const uint8_t* qs0 = reinterpret_cast<const uint8_t*>(__ldg(p.table + T_WQKV_QS));
  const __half* d0 = reinterpret_cast<const __half*>(__ldg(p.table + T_WQKV_D));
  uint64_t* xb = ws::x_bar(smem);
  ws::mbar_expect_tx(xb, 2u * p.d * 4 + (a.tab_smem ? table_bytes(p.L) : 0u));
  ws::bulk_copy(raw, p.x, p.d * 4, xb);
  ws::bulk_copy(g0, g1, p.d * 4, xb);
  if (a.tab_smem) ws::bulk_copy(smem + a.ring.act_off, p.table, table_bytes(p.L), xb);
  ws::Gate<KINDS> gate;
  int n = 0;
  for (int l = 0; l < p.L; ++l) {
#pragma unroll
    for (int k = 0; k < KINDS; ++k) {      // constant k: a.ph stays in the parameter bank
      ws::Phase ph = a.ph[k];
      if (l == 0 && k == 0) {
        ph.qs = qs0;
        ph.d = d0;
      } else {
        if (l == 0 && k == 1) ws::mbar_wait(xb, 0);     // the table has landed
        const unsigned long long* row = tab + (size_t)l * T_SLOTS;
        ph.qs = slot<const uint8_t>(row, qs_slot(k));
        ph.d = slot<const __half>(row, qs_slot(k) + 1);
      }
      ws::produce<F>(smem, a.ring, ph, range[2 * k], range[2 * k + 1], n, gate, l || k);
      if (l == 0 && k == 0) gate.start(a.ph, range, a.ring.ahead);
    }
  }
  ws::produce_tail(smem, a.ring, n);
}

// Over an f32 cache the row pos takes k_cur / v_cur as they are.
template <class C>
__device__ __forceinline__ C cache_elem(float v) {
  if constexpr (std::is_same_v<C, float>) return v;
  else return __float2bfloat16_rn(v);
}

template <int D, bool BF16, class C>
__global__ void __launch_bounds__(ws::THREADS, 1) stack_decode_kernel(StackParams<C> p,
                                                                       StackArgs a) {
  using F = FmtQ4_0;
  extern __shared__ __align__(128) uint8_t smem[];
  const unsigned long long* tab =
      a.tab_smem ? reinterpret_cast<const unsigned long long*>(smem + a.ring.act_off) : p.table;
  float* raw =
      reinterpret_cast<float*>(smem + a.ring.act_off + (a.tab_smem ? table_area(p.L) : 0));
  float* act = raw + p.d;                              // the phases' area
  float* g0 = act + p.d / 32 * ws::XPAD;               // layer 0's attn_norm as copied
  if (threadIdx.x == 0) ws::block_ranges<KINDS>(a.ph, ws::ranges(smem));
  ws::ring_init(smem, a.ring);
  if (threadIdx.x >= ws::CONSUMERS) {      // the producer warp: one thread copies
    if (threadIdx.x == ws::CONSUMERS) produce_stack(smem, p, a, tab, raw, g0);
    return;
  }
  ws::CountBarrier gb;
  gb.start(p.bar + 2);
  float* red = ws::red_area(smem);
  const int* range = ws::ranges(smem);
  const int lane = threadIdx.x & 31;
  const int pos = __ldg(p.pos);
  constexpr int HALF = D / 2;
  constexpr int R = ws::ITEM_ROWS;         // a RoPE pair, a (gate, up) pair, two rows
  const size_t slab = (size_t)p.hkv * p.S * D;
  int n = 0;
  ws::mbar_wait(ws::x_bar(smem), 0);       // x, layer 0's gain, the table

  // the dot of an item's R rows against the staged row at act
  auto dot = [&](const ws::StageView<F>& v, const int (&j)[R], float (&o)[R]) {
    if constexpr (BF16) {
      ws::dot_bf16<R>(v, j, act, lane, o);
    } else {
      float acc[R][1];
      ws::dot_f32<F, R, 1>(v, j, act, 0, lane, acc);
#pragma unroll
      for (int r = 0; r < R; ++r) o[r] = acc[r][0];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) o[r] = warp_sum(o[r]);
  };

  for (int l = 0; l < p.L; ++l) {
    const unsigned long long* row = tab + (size_t)l * T_SLOTS;
    const LayerParams lp{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, p.cos, p.sin,
                         p.ck + l * slab, p.cv + l * slab, nullptr, nullptr, p.pos, nullptr,
                         p.kv_cur + (size_t)l * 2 * p.hkv * D, p.q, p.att, p.part, p.bar,
                         nullptr, nullptr, nullptr, nullptr, p.d, p.hq, p.hkv, p.S, p.n_split,
                         p.eps, p.scale};
    // A: norm x, then QKV in RoPE pairs, rotate, emit (K7's phase A)
    if (l > 0) {
      ws::copy_row(p.xres, p.d, raw);
      ws::sync();
    }
    ws::stage_norm<BF16>(raw, l == 0 ? g0 : slot<const float>(row, T_G1), p.d, p.eps, act, red);
    ws::release(smem, KINDS * l);
    ws::consume_range<F, R>(smem, a.ring, a.ph[PA], range[2 * PA], range[2 * PA + 1], n,
                            [&](const ws::StageView<F>& v, int i, int first) {
      int j[R], at[R];
      ws::item_rows<R>(v, i, j, at);
      float o[R];
      dot(v, j, o);
      if (lane != 0) return;
#pragma unroll
      for (int r = 0; r < R; r += 2) {     // the pair (row, row + hd/2) of RoPE
        float o1 = o[r], o2 = o[r + 1];
        const int r1 = first + at[r], h = r1 / D, ii = r1 % D;
        if (h < p.hq + p.hkv) {            // q and k heads: x*[c,c] + rot(x)*[-s,s]
          const float c = p.cos[ii], s = p.sin[ii];
          const float y1 = o1, y2 = o2;
          o1 = __fsub_rn(__fmul_rn(y1, c), __fmul_rn(y2, s));
          o2 = __fadd_rn(__fmul_rn(y2, c), __fmul_rn(y1, s));
        }
        if (h < p.hq) {
          p.q[h * D + ii] = o1;
          p.q[h * D + ii + HALF] = o2;
        } else {
          const int kvh = h - p.hq;        // 0..hkv-1: k heads, hkv..2hkv-1: v heads
          lp.kv_cur[kvh * D + ii] = o1;
          lp.kv_cur[kvh * D + ii + HALF] = o2;
          C* cache = (kvh < p.hkv ? p.ck : p.cv) + l * slab;
          const size_t c0 = ((size_t)(kvh % p.hkv) * p.S + pos) * D;
          cache[c0 + ii] = cache_elem<C>(o1);
          cache[c0 + ii + HALF] = cache_elem<C>(o2);
        }
      }
    });
    gb.wait();
    // B and the combine (K7's)
    phase_b_merged<D, C>(lp, act, p.heads);
    gb.wait();
    // C: x2 = x + att @ Wo^T
    ws::stage_rows<BF16>(p.att, p.hq * D, act);
    ws::release(smem, KINDS * l + PC);
    ws::consume_range<F, R>(smem, a.ring, a.ph[PC], range[2 * PC], range[2 * PC + 1], n,
                            [&](const ws::StageView<F>& v, int i, int first) {
      int j[R], at[R];
      ws::item_rows<R>(v, i, j, at);
      float o[R];
      dot(v, j, o);
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) p.x2[first + at[r]] = raw[first + at[r]] + o[r];
      }
    });
    gb.wait();
    // gate|up + SwiGLU on n = rmsnorm(x2) * g2 (K6d's at one row)
    ws::copy_row(p.x2, p.d, raw);
    ws::sync();
    ws::stage_norm<BF16>(raw, slot<const float>(row, T_G2), p.d, p.eps, act, red);
    ws::release(smem, KINDS * l + PGU);
    ws::consume_range<F, R>(smem, a.ring, a.ph[PGU], range[2 * PGU], range[2 * PGU + 1], n,
                            [&](const ws::StageView<F>& v, int i, int first) {
      int j[R], at[R];
      ws::item_rows<R>(v, i, j, at);
      float o[R];
      dot(v, j, o);
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < R; r += 2) {   // (gate f, up f)
          const float gate = o[r], up = o[r + 1];
          const float sig = 1.0f / (1.0f + expf(-gate));
          p.act[first + at[r]] = (gate * sig) * up;
        }
      }
    });
    gb.wait();
    // down + residual
    ws::stage_rows<BF16>(p.act, p.F, act);
    ws::release(smem, KINDS * l + PDN);
    float* out = l + 1 == p.L ? p.x_out : p.xres;
    ws::consume_range<F, R>(smem, a.ring, a.ph[PDN], range[2 * PDN], range[2 * PDN + 1], n,
                            [&](const ws::StageView<F>& v, int i, int first) {
      int j[R], at[R];
      ws::item_rows<R>(v, i, j, at);
      float o[R];
      dot(v, j, o);
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) out[first + at[r]] = raw[first + at[r]] + o[r];
      }
    });
    if (l + 1 < p.L) gb.wait();
  }
}

template <int D, bool BF16, class C>
int launch(const StackParams<C>& p, const int* plan, const int* bounds, int device,
           cudaStream_t st) {
  using F = FmtQ4_0;
  static std::atomic<unsigned> ready{0};
  const int nq = p.hq * D;
  const int items = (p.hkv * p.n_split + plan[0] - 1) / plan[0];
  // the plan's act_bytes says where the table is read (stack_plan)
  const size_t act_t = stack_act_bytes<D>(p.L, p.d, p.hq, p.hkv, p.F, items, true);
  const size_t act_g = stack_act_bytes<D>(p.L, p.d, p.hq, p.hkv, p.F, items, false);
  const int tab_smem = (size_t)plan[3] >= act_t;
  const StackArgs a{{ws::plan_phase(plan, PA, nullptr, nullptr, bounds, p.d),
                     ws::plan_phase(plan, PC, nullptr, nullptr, bounds, nq),
                     ws::plan_phase(plan, PGU, nullptr, nullptr, bounds, p.d),
                     ws::plan_phase(plan, PDN, nullptr, nullptr, bounds, p.F)},
                    {plan[1], plan[2], ws::HEADER_BYTES + plan[1] * plan[2], plan[7]},
                    tab_smem};
  // the plan's phases: A over the (hq + 2 hkv) hd rows of wqkv in RoPE-pair
  // runs of one head, C over the d rows of wo, gate|up over F (gate row, up
  // row) pairs, down over d rows; at least one stage ahead, fewer than the ring
  const ws::Phase& pa = a.ph[PA];
  const ws::Phase& pgu = a.ph[PGU];
  if (plan[5] != 1 || plan[6] != KINDS || plan[7] < 1 || plan[7] >= plan[1] || pa.segs != 2 ||
      pa.seg_off != D / 2 || pa.group_rows != D || pa.group_units * pa.unit_rows != D / 2 ||
      a.ph[PC].segs != 1 || pgu.segs != 2 || pgu.seg_off != p.F || a.ph[PDN].segs != 1 ||
      !ws::plan_fits<F>(plan, a.ph, KINDS,
                        tab_smem ? act_t : act_g))
    return ZGML_ERR_SMEM;
  return ws::launch(stack_decode_kernel<D, BF16, C>, p, a, plan[0], plan[4], device, ready, st);
}

template <bool BF16, class C>
int launch_hd(const StackParams<C>& p, int hd, const int* plan, const int* bounds, int device,
              cudaStream_t st) {
  if constexpr (BF16) {
    switch (hd) {    // the JAX tape's head dims (dividing 512) up to 256
      case 64: return launch<64, true, C>(p, plan, bounds, device, st);
      case 128: return launch<128, true, C>(p, plan, bounds, device, st);
      case 256: return launch<256, true, C>(p, plan, bounds, device, st);
      default: return ZGML_ERR_HEAD_DIM;
    }
  } else {
    switch (hd) {    // K7's head dims
      case 32: return launch<32, false, C>(p, plan, bounds, device, st);
      case 64: return launch<64, false, C>(p, plan, bounds, device, st);
      case 96: return launch<96, false, C>(p, plan, bounds, device, st);
      case 128: return launch<128, false, C>(p, plan, bounds, device, st);
      case 160: return launch<160, false, C>(p, plan, bounds, device, st);
      case 192: return launch<192, false, C>(p, plan, bounds, device, st);
      case 224: return launch<224, false, C>(p, plan, bounds, device, st);
      case 256: return launch<256, false, C>(p, plan, bounds, device, st);
      default: return ZGML_ERR_HEAD_DIM;
    }
  }
}

}  // namespace
