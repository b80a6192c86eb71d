// K7's kernel template and launchers (layer_attn.cu describes the kernel):
// over the bf16 and the int8 cache, the modes without phase E are
// instantiated in layer_attn.cu and phase E's (Q4_0, every A phase) in
// layer_attn_ffn.cu; every mode over the f32 cache in layer_attn_f32.cu; so
// nvcc compiles the three in parallel. C, the cache element, is
// __nv_bfloat16, int8_t (levels with per-position scales: kv8) or float.
#pragma once

#include "layer_phases.cuh"

namespace {

// Bytes of phase A's staged activations: the normed x, f32 or int8.
template <bool AI8>
__host__ __device__ size_t staged_a_bytes(int d) {
  return AI8 ? (size_t)ws::xq_words(d) * 4 : (size_t)d / 32 * ws::XPAD * 4;
}

// Bytes of the activation area the phases use (ops/decode_plan.py
// attn_act_bytes): phase A's staged row and, behind it, x and g as copied;
// phase B's chunk and an int for each of a block's `items`; phase C's
// staged attention; with E, x2 as a raw row of d floats and, behind it, the
// staged normed x2 or SwiGLU row.
template <int D, bool AI8, bool KV8>
size_t attn_act_bytes(int d, int hq, int hkv, int items, int f) {
  const size_t a = staged_a_bytes<AI8>(d) + (size_t)2 * d * 4;
  const size_t b = decode_chunk_smem_bytes<D, KV8>(hq / hkv) + (size_t)4 * items;
  const size_t c = (size_t)hq * D / 32 * ws::XPAD * 4;
  const size_t st = (size_t)(d > f ? d : f) / 32 * ws::XPAD * 4;
  const size_t e = f > 0 ? (size_t)d * 4 + st : 0;
  size_t m = a > b ? a : b;
  m = m > c ? m : c;
  return m > e ? m : e;
}

template <class F, int D, bool AI8, class C, bool E>
__global__ void __launch_bounds__(ws::THREADS, 1) layer_attn_kernel(LayerParams p,
                                                                     ws::ArgsN<E ? 4 : 2> a) {
  constexpr int PH = E ? 4 : 2;
  constexpr bool KV8 = std::is_same_v<C, int8_t>;
  extern __shared__ __align__(128) uint8_t smem[];
  ws::ring_init(smem, a.ring);
  // x and g, copied ahead of the weights where both are 16-byte aligned
  float* xin = reinterpret_cast<float*>(smem + a.ring.act_off + staged_a_bytes<AI8>(p.d));
  const bool copy_x = ws::aligned16(p.x) && ws::aligned16(p.g);
  if (threadIdx.x >= ws::CONSUMERS) {      // the producer warp: one thread copies
    if (threadIdx.x == ws::CONSUMERS) {
      if (copy_x) ws::produce_x(smem, xin, p.x, p.d * 4, p.g, p.d * 4);
      int range[2 * PH], n = 0;
      ws::block_ranges<PH>(a.ph, range);
      ws::Gate<PH> gate;                   // each phase: `ahead` stages until its rows are staged
      ws::produce<F>(smem, a.ring, a.ph[0], range[0], range[1], n, gate, false);
      gate.start(a.ph, range, a.ring.ahead);
#pragma unroll
      for (int k = 1; k < PH; ++k)         // constant k: a.ph stays in the parameter bank
        ws::produce<F>(smem, a.ring, a.ph[k], range[2 * k], range[2 * k + 1], n, gate, true);
      ws::produce_tail(smem, a.ring, n);
    }
    return;
  }
  ws::CountBarrier gb;
  gb.start(p.bar + 2);
  float* red = ws::red_area(smem);
  float* act = reinterpret_cast<float*>(smem + a.ring.act_off);
  const int lane = threadIdx.x & 31;
  const int pos = __ldg(p.pos);
  constexpr int HALF = D / 2;
  constexpr int R = ws::ITEM_ROWS;         // a RoPE pair an item
  int n = 0;

  // A: norm (and quantize) x, then QKV in RoPE pairs, rotate, emit
  const float* xr = p.x;
  const float* gr = p.g;
  if (copy_x) {
    ws::mbar_wait(ws::x_bar(smem), 0);
    xr = xin;
    gr = xin + p.d;
  }
  if constexpr (AI8) {
    ws::stage_norm_i8(xr, gr, p.d, p.eps, reinterpret_cast<int*>(act), red, p.xq_out,
                      p.xs_out);
  } else {
    ws::stage_norm(xr, gr, p.d, p.eps, act, red);
  }
  ws::sync();
  ws::consume<F, R>(smem, a.ring, a.ph[0], n, [&](const ws::StageView<F>& v, int i, int row) {
    int j[R], at[R];
    ws::item_rows<R>(v, i, j, at);
    float acc[R][1];
    if constexpr (AI8) {
      ws::dot_i8<F, R, 1>(v, j, reinterpret_cast<const int*>(act), 0, lane, acc);
    } else {
      ws::dot_f32<F, R, 1>(v, j, act, 0, lane, acc);
    }
    float o[R];
#pragma unroll
    for (int r = 0; r < R; ++r) o[r] = warp_sum(acc[r][0]);
#pragma unroll
    for (int r = 0; r < R; r += 2) {       // the pair (row, row + hd/2) of RoPE
      if (lane != 0) continue;
      float o1 = o[r], o2 = o[r + 1];
      const int r1 = row + at[r], h = r1 / D, ii = r1 % D;
      if (h < p.hq + p.hkv) {              // q and k heads: x*[c,c] + rot(x)*[-s,s]
        const float c = p.cos[ii], s = p.sin[ii];
        const float y1 = o1, y2 = o2;
        o1 = __fsub_rn(__fmul_rn(y1, c), __fmul_rn(y2, s));
        o2 = __fadd_rn(__fmul_rn(y2, c), __fmul_rn(y1, s));
      }
      if (h < p.hq) {
        p.q[h * D + ii] = o1;
        p.q[h * D + ii + HALF] = o2;
      } else {
        const int kvh = h - p.hq;          // 0..hkv-1: k heads, hkv..2hkv-1: v heads
        p.kv_cur[kvh * D + ii] = o1;
        p.kv_cur[kvh * D + ii + HALF] = o2;
        if constexpr (std::is_same_v<C, float>) {   // the f32 cache: k_cur, v_cur as they are
          float* cache = static_cast<float*>(kvh < p.hkv ? p.ck : p.cv);
          const size_t c0 = ((size_t)(kvh % p.hkv) * p.S + pos) * D;
          cache[c0 + ii] = o1;
          cache[c0 + ii + HALF] = o2;
        } else if constexpr (!KV8) {       // kv8: quantized after the combine
          __nv_bfloat16* cache = static_cast<__nv_bfloat16*>(kvh < p.hkv ? p.ck : p.cv);
          const size_t c0 = ((size_t)(kvh % p.hkv) * p.S + pos) * D;
          cache[c0 + ii] = __float2bfloat16_rn(o1);
          cache[c0 + ii + HALF] = __float2bfloat16_rn(o2);
        }
      }
    }
  });
  gb.wait();
  phase_b_merged<D, C>(p, act, a.counters);
  gb.wait();

  // C: x_out = x + att @ Wo^T
  ws::stage_rows(p.att, p.hq * D, act);
  ws::release(smem, 1);                    // wo may stream in full
  ws::consume<F, R>(smem, a.ring, a.ph[1], n, [&](const ws::StageView<F>& v, int i, int row) {
    int j[R], at[R];
    ws::item_rows<R>(v, i, j, at);
    float acc[R][1];
    ws::dot_f32<F, R, 1>(v, j, act, 0, lane, acc);
    float o[R];
#pragma unroll
    for (int r = 0; r < R; ++r) o[r] = warp_sum(acc[r][0]);
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) p.x_out[row + at[r]] = __ldcg(p.x + row + at[r]) + o[r];
    }
  });
  if constexpr (E) {
    // E: K6d's function at one row on x2 = x_out: gate|up + SwiGLU on n =
    // rmsnorm(x2) * g2, then down + residual into x_out (every block has
    // read x2 into `raw` before the barrier that precedes down)
    float* raw = act;
    float* st = act + p.d;
    gb.wait();
    ws::copy_row(p.x_out, p.d, raw);
    ws::sync();
    ws::stage_norm(raw, p.g2, p.d, p.eps, st, red);
    ws::release(smem, 2);
    ws::consume<F, R>(smem, a.ring, a.ph[2], n, [&](const ws::StageView<F>& v, int i, int row) {
      int j[R], at[R];
      ws::item_rows<R>(v, i, j, at);
      float acc[R][1];
      ws::dot_f32<F, R, 1>(v, j, st, 0, lane, acc);
#pragma unroll
      for (int r = 0; r < R; r += 2) {     // (gate f, up f)
        const float gate = warp_sum(acc[r][0]);
        const float up = warp_sum(acc[r + 1][0]);
        if (lane == 0) {
          const float sig = 1.0f / (1.0f + expf(-gate));
          p.act[row + at[r]] = (gate * sig) * up;
        }
      }
    });
    gb.wait();
    ws::stage_rows(p.act, p.F, st);
    ws::release(smem, 3);
    ws::consume<F, R>(smem, a.ring, a.ph[3], n, [&](const ws::StageView<F>& v, int i, int row) {
      int j[R], at[R];
      ws::item_rows<R>(v, i, j, at);
      float acc[R][1];
      ws::dot_f32<F, R, 1>(v, j, st, 0, lane, acc);
      float o[R];
#pragma unroll
      for (int r = 0; r < R; ++r) o[r] = warp_sum(acc[r][0]);
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) p.x_out[row + at[r]] = raw[row + at[r]] + o[r];
      }
    });
  }
}

template <class F, int D, bool AI8, class C, bool E>
int launch(const LayerParams& p, unsigned int* heads, const int* plan, const int* bounds,
           int device, cudaStream_t st) {
  static std::atomic<unsigned> ready{0};
  constexpr int PH = E ? 4 : 2;
  constexpr bool KV8 = std::is_same_v<C, int8_t>;
  const int nq = p.hq * D;
  ws::ArgsN<PH> a{};
  a.ph[0] = ws::plan_phase(plan, 0, p.wqkv_qs, p.wqkv_d, bounds, p.d);
  a.ph[1] = ws::plan_phase(plan, 1, p.wo_qs, p.wo_d, bounds, nq);
  if constexpr (E) {
    a.ph[2] = ws::plan_phase(plan, 2, p.gu_qs, p.gu_d, bounds, p.d);
    a.ph[3] = ws::plan_phase(plan, 3, p.dn_qs, p.dn_d, bounds, p.F);
  }
  a.ring = {plan[1], plan[2], ws::HEADER_BYTES + plan[1] * plan[2], plan[7]};
  a.counters = heads;
  // the plan's phases: A over the (hq + 2 hkv) hd rows of wqkv in RoPE-pair
  // runs of one head, C over the d rows of wo; with E gate|up over F (gate
  // row, up row) pairs and down over d rows
  const ws::Phase& pa = a.ph[0];
  const ws::Phase& pc = a.ph[1];
  if (plan[5] != 1 || plan[6] != PH || pa.segs != 2 || pa.seg_off != D / 2 ||
      pa.group_rows != D || pa.group_units * pa.unit_rows != D / 2 || pc.segs != 1 ||
      (E && (a.ph[2].segs != 2 || a.ph[2].seg_off != p.F || a.ph[PH - 1].segs != 1)) ||
      !ws::plan_fits<F>(plan, a.ph, PH,
                        attn_act_bytes<D, AI8, KV8>(p.d, p.hq, p.hkv,
                                                    (p.hkv * p.n_split + plan[0] - 1) / plan[0],
                                                    E ? p.F : 0)))
    return ZGML_ERR_SMEM;
  return ws::launch(layer_attn_kernel<F, D, AI8, C, E>, p, a, plan[0], plan[4], device, ready,
                    st);
}

template <class F, bool AI8, class C, bool E>
int launch_hd(const LayerParams& p, unsigned int* heads, int hd, const int* plan,
              const int* bounds, int device, cudaStream_t st) {
  switch (hd) {      // the JAX rule's head dims (multiples of 32) up to 256
    case 32: return launch<F, 32, AI8, C, E>(p, heads, plan, bounds, device, st);
    case 64: return launch<F, 64, AI8, C, E>(p, heads, plan, bounds, device, st);
    case 96: return launch<F, 96, AI8, C, E>(p, heads, plan, bounds, device, st);
    case 128: return launch<F, 128, AI8, C, E>(p, heads, plan, bounds, device, st);
    case 160: return launch<F, 160, AI8, C, E>(p, heads, plan, bounds, device, st);
    case 192: return launch<F, 192, AI8, C, E>(p, heads, plan, bounds, device, st);
    case 224: return launch<F, 224, AI8, C, E>(p, heads, plan, bounds, device, st);
    case 256: return launch<F, 256, AI8, C, E>(p, heads, plan, bounds, device, st);
    default: return ZGML_ERR_HEAD_DIM;
  }
}

}  // namespace

// Launch phase E's instantiation of the mode (a_i8, kv8) at Q4_0 over the
// bf16 or the int8 cache (layer_attn_ffn.cu).
int launch_attn_ffn(const LayerParams& p, int a_i8, int kv8, unsigned int* heads, int hd,
                    const int* plan, const int* bounds, int device, cudaStream_t st);
// Launch the instantiation of the mode (kind, a_i8, phase E where e) over the
// f32 cache (layer_attn_f32.cu); phase E at kind 0 (Q4_0) only.
int launch_attn_f32kv(const LayerParams& p, int kind, int a_i8, int e, unsigned int* heads,
                      int hd, const int* plan, const int* bounds, int device, cudaStream_t st);
