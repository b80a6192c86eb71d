// K7 over the f32 KV cache: layer_attn.cuh's kernel with C = float, in every
// A phase, at both kinds without phase E and at Q4_0 with it (JAX's has_ffn).
// layer_attn.cu describes the kernel and exports the launcher; these
// instantiations are a translation unit of their own, so nvcc compiles them
// beside layer_attn.cu and layer_attn_ffn.cu.
//
// The f32 cache is the JAX package's init_cache(batch, jnp.float32): the row
// K7 writes at pos is k_cur / v_cur as they are (layerkernel.py:311-314 cast
// them to the cache's dtype, f32 here), and phase B reads the rows below pos
// in f32 (decode_split.cuh's f32 element: K staged and scored, then V staged
// into the same buffer, so the activation area and the plans are the bf16
// cache's). What bounds it: the weight bytes as over the bf16 cache, plus
// the slab's rows below pos at 4 bytes an element (twice the bf16 cache's).
#include "layer_attn.cuh"

int launch_attn_f32kv(const LayerParams& p, int kind, int a_i8, int e, unsigned int* heads,
                      int hd, const int* plan, const int* bounds, int device, cudaStream_t st) {
  if (e) {           // JAX's has_ffn: Q4_0 only
    if (kind != 0) return ZGML_ERR_KIND;
    using F = FmtQ4_0;
    return a_i8 ? launch_hd<F, true, float, true>(p, heads, hd, plan, bounds, device, st)
                : launch_hd<F, false, float, true>(p, heads, hd, plan, bounds, device, st);
  }
  ZGML_DISPATCH_KIND(kind, return a_i8 ? launch_hd<F, true, float, false>(p, heads, hd, plan,
                                                                         bounds, device, st)
                                       : launch_hd<F, false, float, false>(p, heads, hd, plan,
                                                                          bounds, device, st))
}
