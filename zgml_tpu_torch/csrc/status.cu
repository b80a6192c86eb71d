// Text of the status codes the launchers return (see common.cuh).
#include "common.cuh"

ZGML_EXPORT const char* zgml_error_string(int code) {
  switch (code) {
    case ZGML_ERR_SHAPE: return "shape outside what the kernel takes";
    case ZGML_ERR_HEAD_DIM: return "head_dim has no compiled instantiation";
    case ZGML_ERR_SMEM: return "tile needs more shared memory than the card allows";
    case ZGML_ERR_KIND: return "weight kind has no compiled instantiation (0 = q4_0, 1 = q8_0)";
    default: return cudaGetErrorString((cudaError_t)code);
  }
}
