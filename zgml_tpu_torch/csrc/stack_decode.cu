// K14 / K15 over the bf16 cache, and the exported launcher of both caches.
// stack_decode.cuh describes the kernel; the f32 cache's instantiations are
// stack_decode_f32.cu's.
#include "stack_decode.cuh"

// bf16_ops 1 for K15's bf16 operands, 0 for f32 (K14, and K15 under
// ZGML_TPU_TAPE_BF16=0); kv the cache form (ops/decode_plan.py KV_BF16 0,
// KV_F32 2); table int64 [L, 10] device pointers per layer (g1, g2 f32 [d];
// wqkv qs/d; wo qs/d; w_gate_up qs/d [2F, d]; w_down qs/d [d, F]; Q4_0
// planes of quant/packed.py; all 16-byte aligned); x f32 [d] (16-byte
// aligned); cos/sin f32 [hd/2]; ck/cv bf16 or f32 [L, hkv, S, hd] (written
// at row *pos of every layer); pos int32 [1] on the device; outputs x_out f32
// [d] and kv_cur f32 [L, 2, hkv, hd]; scratch f32 q [hq hd], att [hq hd],
// part [hq, n_split, hd + 2] with n_split = zgml_decode_split_count(S), x2
// [d], xres [d], act [F] (x2 and xres 16-byte aligned); bar: four uint32
// words of a zeroed workspace (words 2 and 3 left zeroed); heads: hkv uint32
// words of a zeroed workspace (left zeroed); plan: the host ints of
// ops/decode_plan.py stack_plan (host_ints), bounds: its int32 [4, grid + 1]
// range bounds on the card; device: the card's index. All contiguous.
ZGML_EXPORT int zgml_stack_decode(int bf16_ops, int kv, const void* table, const float* x,
                                  const float* cos, const float* sin, void* ck, void* cv,
                                  const int* pos, float* x_out, float* kv_cur, float* q,
                                  float* att, float* part, float* x2, float* xres, float* act,
                                  unsigned int* bar, unsigned int* heads, int L, int d, int hq,
                                  int hkv, int hd, int S, int F, float eps, float scale,
                                  const int* plan, const int* bounds, int device, void* stream) {
  if (L <= 0 || d <= 0 || d % 32 != 0 || F <= 0 || F % 32 != 0 || hq <= 0 || hkv <= 0 ||
      hq % hkv != 0 || hq * hd != d || S <= 0 || heads == nullptr || plan == nullptr ||
      bounds == nullptr || !ws::aligned16(x) || !ws::aligned16(x2) || !ws::aligned16(xres) ||
      (kv != 0 && kv != 2))
    return ZGML_ERR_SHAPE;
  const auto tab = static_cast<const unsigned long long*>(table);
  const int n_split = (S + DA_CHUNK - 1) / DA_CHUNK;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv == 2) {
    const StackParams<float> p{tab, x, cos, sin, static_cast<float*>(ck),
                               static_cast<float*>(cv), pos, x_out, kv_cur, q, att, part, x2,
                               xres, act, bar, heads, L, d, hq, hkv, S, n_split, F, eps, scale};
    return launch_stack_f32kv(p, bf16_ops, hd, plan, bounds, device, st);
  }
  const StackParams<__nv_bfloat16> p{tab, x, cos, sin, static_cast<__nv_bfloat16*>(ck),
                                     static_cast<__nv_bfloat16*>(cv), pos, x_out, kv_cur, q,
                                     att, part, x2, xres, act, bar, heads, L, d, hq, hkv, S,
                                     n_split, F, eps, scale};
  return bf16_ops ? launch_hd<true>(p, hd, plan, bounds, device, st)
                  : launch_hd<false>(p, hd, plan, bounds, device, st);
}
