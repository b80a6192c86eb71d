// K14 / K15 over the f32 KV cache: stack_decode.cuh's kernel with C = float,
// for both operand roundings. stack_decode.cu exports the launcher; these
// instantiations are a translation unit of their own, so nvcc compiles them
// beside it.
//
// The f32 cache is the JAX package's init_cache(batch, jnp.float32) in its
// stacked layout: row pos of every layer takes k_cur / v_cur as they are, and
// phase B reads the rows below pos in f32 (K7's f32-cache phase B,
// layer_attn_f32.cu), so the plan is the bf16 cache's. What bounds it: the
// weight bytes as over the bf16 cache, plus the live rows at 4 bytes an
// element (twice the bf16 cache's).
#include "stack_decode.cuh"

int launch_stack_f32kv(const StackParams<float>& p, int bf16_ops, int hd, const int* plan,
                       const int* bounds, int device, cudaStream_t st) {
  return bf16_ops ? launch_hd<true>(p, hd, plan, bounds, device, st)
                  : launch_hd<false>(p, hd, plan, bounds, device, st);
}
