// K7 with its phase E (ZGML_TPU_LAYER_FFN): the instantiations of
// layer_attn.cuh's kernel with E true, at Q4_0 (JAX's has_ffn), in every A
// phase over the bf16 and the int8 cache (the f32 cache's are in
// layer_attn_f32.cu); layer_attn.cu describes the kernel and exports the
// launcher. A translation unit of its own, so nvcc compiles it beside
// layer_attn.cu.
#include "layer_attn.cuh"

int launch_attn_ffn(const LayerParams& p, int a_i8, int kv8, unsigned int* heads, int hd,
                    const int* plan, const int* bounds, int device, cudaStream_t st) {
  using F = FmtQ4_0;
  using B = __nv_bfloat16;
  if (a_i8 && kv8) return launch_hd<F, true, int8_t, true>(p, heads, hd, plan, bounds, device, st);
  if (a_i8) return launch_hd<F, true, B, true>(p, heads, hd, plan, bounds, device, st);
  if (kv8) return launch_hd<F, false, int8_t, true>(p, heads, hd, plan, bounds, device, st);
  return launch_hd<F, false, B, true>(p, heads, hd, plan, bounds, device, st);
}
