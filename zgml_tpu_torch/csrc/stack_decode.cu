// K14 stack_decode / K15 tape_decode: one batch-1 decode token through every
// layer of a Llama stack in one launch, Q4_0 weights, bf16 cache.
//
// Replaces: zgml_tpu/ops/stackkernel.py `_stack_kernel` (pallas_call at line
// 422, entry `stacked_decode_step`; BF16_OPS false) and
// zgml_tpu/ops/tapekernel.py `_tape_kernel` (pallas_call at line 553, entry
// `tape_decode_step`; BF16_OPS true, or false under ZGML_TPU_TAPE_BF16=0).
// The JAX package reaches them from models/llama.py:753-771 when
// LlamaModel.enable_stacked_decode() / enable_tape_decode() attached their
// views and ZGML_TPU_STACK_DECODE / ZGML_TPU_TAPE_DECODE is on. Those views
// are copies of the weights laid out for the TPU (stacked [L, ...] tiles, one
// flat tape of 512-lane entries streamed through a hand-DMA'd VMEM window);
// here the kernel reads the port's one resident copy through a table of
// per-layer pointers (ops/stackkernel.py StackedLayers).
//
// Semantics (plain versions: ops/stackkernel.py stacked_decode_ref, ops/
// tapekernel.py tape_decode_ref): for l = 0 .. L-1, K7's function (f32 A
// phase, the bf16 cache) then K6d's:
//   x2 = x + attn(rmsnorm(x) * g1) @ Wo^T, writing k_cur / v_cur of layer l
//        rounded to bf16 into cache row pos (phase B reads rows < pos only,
//        so the cache ends as the JAX package's, which writes all layers'
//        rows after the call);
//   x  = x2 + down(silu(gate(n)) * up(n)), n = rmsnorm(x2) * g2.
// K14 takes the f32 A phase whatever ZGML_TPU_ATTN_I8A says, as the JAX
// kernel does. With BF16_OPS (K15, tapekernel.py _deq_rows and the
// `.astype(mxu)` calls at :319-323, 428-431, 451) every weight element is
// bf16_rn(level * bf16_rn(scale)) and the four staged operand rows (the normed
// x, att, the normed x2, the SwiGLU activation) are rounded to bf16 once;
// products are exact in f32 and summed in f32; attention, norms and residuals
// stay f32.
//
// What bounds it on the H100: the weight bytes, read once per token (24.8 MB
// a layer at TinyLlama-1.1B at Q4_0, 545 MB for its 22 layers: ~163 us at
// 3.35 TB/s), plus the live cache rows (1 KB per position and layer at
// TinyLlama-1.1B). Its grid barriers (six a layer, 131 at 22 layers) cost a
// few microseconds each and are not in that bound.
//
// What the design does about it: one cooperative launch (every block
// resident, grid sized by the occupancy query for the widest phase) replaces
// the per-layer path's 2 launches a layer and the host work between them; the
// layer loop runs inside it, the phases of layer_phases.cuh (the very code of
// K7 and K6d) separated by grid barriers on the words of ops/coop.py:
//   A | B | combine | C | gate|up | down | (next layer's A)
// x and x2 stay in a global f32 scratch of [d] each, act in one of [F], read
// back with __ldcg. Head dims 32-256 with f32 operands, 64, 128 and 256 with
// bf16 ones (the JAX tape takes head dims dividing 512). No float atomics.
#include "layer_phases.cuh"

namespace {

static_assert(LK_THREADS == FFN_THREADS, "the megacall runs both halves in one block shape");

// Per-layer pointers, in the order of ops/stackkernel.py TABLE.
enum TableSlot : int {
  T_G1, T_G2, T_WQKV_QS, T_WQKV_D, T_WO_QS, T_WO_D, T_GU_QS, T_GU_D, T_DN_QS, T_DN_D, T_SLOTS
};

struct StackParams {
  const unsigned long long* table;   // [L][T_SLOTS] device pointers
  const float* x;                    // [d]: layer 0's input
  const float* cos;                  // [hd/2] at pos
  const float* sin;
  __nv_bfloat16* ck;                 // [L, hkv, S, hd]
  __nv_bfloat16* cv;
  const int* pos;                    // [1], device
  float* x_out;                      // [d]
  float* kv_cur;                     // [L, 2, hkv, hd]: each layer's rotated k, then v
  float* q;                          // [hq, hd] scratch
  float* att;                        // [hq, hd] scratch
  float* part;                       // [hq, n_split, hd + 2] scratch
  float* x2;                         // [d] scratch: x + attention
  float* xres;                       // [d] scratch: the residual between layers
  float* act;                        // [F] scratch
  unsigned int* bar;                 // grid-barrier words
  int L, d, hq, hkv, S, n_split, F;
  float eps, scale;
};

template <class T>
__device__ __forceinline__ T* slot(const unsigned long long* row, int s) {
  return reinterpret_cast<T*>(__ldg(row + s));
}

template <class F, int D, bool BF16_OPS>
__global__ void __launch_bounds__(LK_THREADS) stack_decode_kernel(StackParams p) {
  extern __shared__ __align__(16) float smem[];
  const size_t slab = (size_t)p.hkv * p.S * D;
  for (int l = 0; l < p.L; ++l) {
    const unsigned long long* row = p.table + (size_t)l * T_SLOTS;
    const LayerParams lp{l == 0 ? p.x : p.xres, slot<const float>(row, T_G1),
                         slot<const uint8_t>(row, T_WQKV_QS), slot<const __half>(row, T_WQKV_D),
                         slot<const uint8_t>(row, T_WO_QS), slot<const __half>(row, T_WO_D),
                         p.cos, p.sin, p.ck + l * slab, p.cv + l * slab, nullptr, nullptr,
                         p.pos, p.x2, p.kv_cur + (size_t)l * 2 * p.hkv * D, p.q, p.att, p.part,
                         p.bar, nullptr, nullptr, nullptr, nullptr, p.d, p.hq, p.hkv, p.S,
                         p.n_split, p.eps, p.scale};
    attn_phase_a<F, D, BF16_OPS>(lp, smem);
    grid_barrier(p.bar);
    attn_phase_b<D>(lp, smem);
    grid_barrier(p.bar);
    attn_combine<D>(lp);
    grid_barrier(p.bar);
    attn_phase_c<F, D, BF16_OPS>(lp, smem);
    grid_barrier(p.bar);
    const FfnParams fp{p.x2, slot<const float>(row, T_G2), slot<const uint8_t>(row, T_GU_QS),
                       slot<const __half>(row, T_GU_D), slot<const uint8_t>(row, T_DN_QS),
                       slot<const __half>(row, T_DN_D), l + 1 == p.L ? p.x_out : p.xres, p.act,
                       p.bar, nullptr, nullptr, 1, p.d, p.F, p.eps};
    ffn_phase_gu<F, 1, BF16_OPS>(fp, 0, 1, smem);
    grid_barrier(p.bar);
    ffn_phase_down<F, 1, BF16_OPS>(fp, 0, 1, smem);
    if (l + 1 < p.L) grid_barrier(p.bar);
  }
}

template <class F, int D, bool BF16_OPS>
int launch(const StackParams& p, cudaStream_t st) {
  size_t smem = attn_smem_bytes<D>(p.d, p.hq, p.hkv);
  const size_t smem_f = sizeof(float) * (32 + ffn_row_floats(p.d, p.F));
  if (smem_f > smem) smem = smem_f;
  int warps = attn_max_warps<D>(p.d, p.hq, p.hkv);
  if (p.F > warps) warps = p.F;
  return launch_cooperative(stack_decode_kernel<F, D, BF16_OPS>, LK_THREADS, smem,
                            (warps + LK_WARPS - 1) / LK_WARPS, p, st);
}

template <bool BF16_OPS>
int launch_hd(const StackParams& p, int hd, cudaStream_t st) {
  using F = FmtQ4_0;
  if constexpr (BF16_OPS) {
    switch (hd) {    // the JAX tape's head dims (dividing 512) up to 256
      case 64: return launch<F, 64, true>(p, st);
      case 128: return launch<F, 128, true>(p, st);
      case 256: return launch<F, 256, true>(p, st);
      default: return ZGML_ERR_HEAD_DIM;
    }
  } else {
    switch (hd) {    // K7's head dims
      case 32: return launch<F, 32, false>(p, st);
      case 64: return launch<F, 64, false>(p, st);
      case 96: return launch<F, 96, false>(p, st);
      case 128: return launch<F, 128, false>(p, st);
      case 160: return launch<F, 160, false>(p, st);
      case 192: return launch<F, 192, false>(p, st);
      case 224: return launch<F, 224, false>(p, st);
      case 256: return launch<F, 256, false>(p, st);
      default: return ZGML_ERR_HEAD_DIM;
    }
  }
}

}  // namespace

// bf16_ops 1 for K15's bf16 operands, 0 for f32 (K14, and K15 under
// ZGML_TPU_TAPE_BF16=0); table int64 [L, 10] device pointers per layer (g1,
// g2 f32 [d]; wqkv qs/d; wo qs/d; w_gate_up qs/d [2F, d]; w_down qs/d [d, F];
// Q4_0 planes of quant/packed.py); x f32 [d]; cos/sin f32 [hd/2]; ck/cv bf16
// [L, hkv, S, hd] (written at row *pos of every layer); pos int32 [1] on the
// device; outputs x_out f32 [d] and kv_cur f32 [L, 2, hkv, hd]; scratch f32 q
// [hq hd], att [hq hd], part [hq, n_split, hd + 2] with n_split =
// zgml_decode_split_count(S), x2 [d], xres [d], act [F]; bar: two uint32 words
// of a zeroed workspace. All contiguous.
ZGML_EXPORT int zgml_stack_decode(int bf16_ops, const void* table, const float* x,
                                  const float* cos, const float* sin, void* ck, void* cv,
                                  const int* pos, float* x_out, float* kv_cur, float* q,
                                  float* att, float* part, float* x2, float* xres, float* act,
                                  unsigned int* bar, int L, int d, int hq, int hkv, int hd, int S,
                                  int F, float eps, float scale, void* stream) {
  if (L <= 0 || d <= 0 || d % 32 != 0 || F <= 0 || F % 32 != 0 || hq <= 0 || hkv <= 0 ||
      hq % hkv != 0 || hq * hd % 32 != 0 || S <= 0)
    return ZGML_ERR_SHAPE;
  const StackParams p{static_cast<const unsigned long long*>(table), x, cos, sin,
                      static_cast<__nv_bfloat16*>(ck), static_cast<__nv_bfloat16*>(cv), pos,
                      x_out, kv_cur, q, att, part, x2, xres, act, bar, L, d, hq, hkv, S,
                      (S + DA_CHUNK - 1) / DA_CHUNK, F, eps, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16_ops ? launch_hd<true>(p, hd, st) : launch_hd<false>(p, hd, st);
}
