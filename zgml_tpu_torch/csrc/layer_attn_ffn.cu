// K7 with its phase E (ZGML_TPU_LAYER_FFN): the instantiations of
// layer_attn.cuh's kernel with E true, at Q4_0 (JAX's has_ffn), in every A
// phase and cache mode; layer_attn.cu describes the kernel and exports the
// launcher. A translation unit of its own, so nvcc compiles it beside
// layer_attn.cu.
#include "layer_attn.cuh"

int launch_attn_ffn(const LayerParams& p, int a_i8, int kv8, unsigned int* heads, int hd,
                    const int* plan, const int* bounds, int device, cudaStream_t st) {
  using F = FmtQ4_0;
  if (a_i8 && kv8) return launch_hd<F, true, true, true>(p, heads, hd, plan, bounds, device, st);
  if (a_i8) return launch_hd<F, true, false, true>(p, heads, hd, plan, bounds, device, st);
  if (kv8) return launch_hd<F, false, true, true>(p, heads, hd, plan, bounds, device, st);
  return launch_hd<F, false, false, true>(p, heads, hd, plan, bounds, device, st);
}
