// K6b fused_ffn: y = down(silu(gate(h)) * up(h)) for M <= 32 rows of an
// already-normed h, Q4_0 weights, f32 dequant, no residual, in one launch.
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
// up_f = h . dequant(W_up[f]); y[j] = sum_f act[f] * dequant(W_down[j, f]); f32.
//
// What bounds it on the H100: the weight bytes, 3 D F * 0.5625 (76.1 MB at
// Llama-2-7B, 19.5 MB at TinyLlama-1.1B), which it reads once for all M
// rows, and its f32 operations, 6 M D F (8.7 GFLOP at 7B and M = 32, 129 us
// at 67 TFLOP/s): bytes below M ~ 6, operations above.
//
// What the design does about it: the point (where K6d takes its rows four at
// a time and re-reads the weights per group) is to read each weight block
// once whatever M. One cooperative launch, two phases, a grid barrier between
// them; each phase is a GEMV of R weight rows per item over all M rows of its
// input, with the contraction cut into chunks of KC = 32 blocks (1024 values):
//   per chunk, every block stages that chunk of all M input rows in shared
//   memory ([M][KC][HS] f32, at most 147 KB: the whole of 32 rows would not
//   fit), then each warp takes items of the block's group: lane l loads block
//   l of the chunk of each of the item's rows once, unpacks its 32 levels into
//   registers and dots them with every input row (two rows at a time, 16-byte
//   shared loads, four partial sums each, so the FMAs do not wait on one
//   another); the warp's sum per (row, m) goes into the group's accumulator
//   in shared memory. After the last chunk the group's outputs are written.
//     1. items = pairs (f, F + f) of w_gate_up over h -> act[m][f] =
//        silu(gate) * up (a global scratch [M, F]);
//     2. after the barrier, items = rows j of w_down over act -> y[m][j].
// A block's group is a contiguous range of items, so each input row is read
// from L2 once per group, and each weight block from HBM once. The order of
// every sum is fixed and there are no float atomics: the result does not
// change from run to run.
#include "common.cuh"

namespace {

constexpr int FP_THREADS = 512;
constexpr int FP_WARPS = FP_THREADS / 32;
constexpr int KC = 32;        // blocks of the contraction per chunk: one per lane
constexpr int GP_MAX = 128;   // items per group (the accumulator's capacity)
// floats per staged 32-block: 32 and 4 of padding, so rows stay 16-byte
// aligned and the 8 lanes of each quarter-warp's 16-byte load hit 32 banks
constexpr int HS = 36;

struct FfnPlanarParams {
  const float* h;          // [M, D], normed
  const uint8_t* gu_qs;    // [2F, D/32 * BYTES]
  const __half* gu_d;      // [2F, D/32]
  const uint8_t* dn_qs;    // [D, F/32 * BYTES]
  const __half* dn_d;      // [D, F/32]
  float* y;                // [M, D]
  float* act;              // [M, F] scratch
  unsigned int* bar;       // grid-barrier words
  int M, D, F;
};

// Shared floats of the kernel at M rows: the accumulator, then the chunk.
__host__ __device__ inline size_t planar_smem_floats(int M) {
  return (size_t)GP_MAX * 2 * M + (size_t)M * KC * HS;
}

// out[m][i] for items i of src [M, K] against weight rows i + r * row_step
// (r < R); with R == 2 the output is silu(row 0) * row 1, else row 0. src is
// read with __ldcg (phase 2's act is written in the same kernel).
template <class F, int R>
__device__ void gemv_chunked(const uint8_t* qs, const __half* dq, int n_items, int row_step,
                             const float* src, int K, int M, float* out, int ld_out,
                             float* accs, float* hs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nbk = K / 32;
  int gp = (n_items + gridDim.x - 1) / gridDim.x;
  if (gp > GP_MAX) gp = GP_MAX;
  for (int i0 = blockIdx.x * gp; i0 < n_items; i0 += gridDim.x * gp) {
    const int np = min(gp, n_items - i0);
    for (int i = threadIdx.x; i < np * R * M; i += blockDim.x) accs[i] = 0.f;
    for (int c0 = 0; c0 < nbk; c0 += KC) {
      const int nb = min(KC, nbk - c0);
      __syncthreads();                     // the last chunk's readers are done
      for (int i = threadIdx.x; i < M * nb * 32; i += blockDim.x) {
        const int m = i / (nb * 32), e = i % (nb * 32);
        hs[(m * KC + (e >> 5)) * HS + (e & 31)] = __ldcg(src + (size_t)m * K + c0 * 32 + e);
      }
      __syncthreads();
      const bool live = lane < nb;         // lane l takes block c0 + l
      for (int pi = warp; pi < np; pi += FP_WARPS) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const size_t row = (size_t)(i0 + pi) + (size_t)r * row_step;
          float lv[32];
          float s = 0.f;
          if (live) {
            uint32_t w[F::WORDS];
            load_block<F>(qs + row * nbk * F::BYTES, c0 + lane, w);
            s = __half2float(dq[row * nbk + c0 + lane]);
#pragma unroll
            for (int j = 0; j < 32; ++j) lv[j] = F::level(w, j);
          }
          for (int m = 0; m < M; m += 2) {
            const bool two = m + 1 < M;                // the same for the whole warp
            float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
            if (live) {
              const float4* x0 = reinterpret_cast<const float4*>(hs + (m * KC + lane) * HS);
              const float4* x1 = x0 + KC * HS / 4;    // row m + 1
#pragma unroll
              for (int q = 0; q < 8; ++q) {
                const float4 a = x0[q];
                d0[0] = fmaf(lv[4 * q], a.x, d0[0]);
                d0[1] = fmaf(lv[4 * q + 1], a.y, d0[1]);
                d0[2] = fmaf(lv[4 * q + 2], a.z, d0[2]);
                d0[3] = fmaf(lv[4 * q + 3], a.w, d0[3]);
                if (two) {
                  const float4 b = x1[q];
                  d1[0] = fmaf(lv[4 * q], b.x, d1[0]);
                  d1[1] = fmaf(lv[4 * q + 1], b.y, d1[1]);
                  d1[2] = fmaf(lv[4 * q + 2], b.z, d1[2]);
                  d1[3] = fmaf(lv[4 * q + 3], b.w, d1[3]);
                }
              }
            }
            const float t0 = warp_sum(((d0[0] + d0[1]) + (d0[2] + d0[3])) * s);
            if (lane == 0) accs[(pi * R + r) * M + m] += t0;
            if (two) {
              const float t1 = warp_sum(((d1[0] + d1[1]) + (d1[2] + d1[3])) * s);
              if (lane == 0) accs[(pi * R + r) * M + m + 1] += t1;
            }
          }
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < np * M; i += blockDim.x) {
      const int pi = i / M, m = i % M;
      float v = accs[pi * R * M + m];
      if constexpr (R == 2) {
        const float up = accs[(pi * 2 + 1) * M + m];
        v = (v * (1.0f / (1.0f + expf(-v)))) * up;
      }
      out[(size_t)m * ld_out + i0 + pi] = v;
    }
    __syncthreads();                       // accs is zeroed for the next group
  }
}

template <class F>
__global__ void __launch_bounds__(FP_THREADS) ffn_planar_kernel(FfnPlanarParams p) {
  extern __shared__ __align__(16) float smem[];
  float* accs = smem;                           // [GP_MAX][2][M]
  float* hs = smem + (size_t)GP_MAX * 2 * p.M;  // [M][KC][33]
  gemv_chunked<F, 2>(p.gu_qs, p.gu_d, p.F, p.F, p.h, p.D, p.M, p.act, p.F, accs, hs);
  grid_barrier(p.bar);
  gemv_chunked<F, 1>(p.dn_qs, p.dn_d, p.D, 0, p.act, p.F, p.M, p.y, p.D, accs, hs);
}

}  // namespace

// Q4_0 only (the JAX kernel's only kind; at Q8_0 the JAX package runs K6a):
// h f32 [M, D] (normed), w_gate_up (qs [2F, D/2], d fp16 [2F, D/32]), w_down
// (qs [D, F/2], d fp16 [D, F/32]) -> y f32 [M, D]; act f32 [M, F] scratch;
// bar: two uint32 words of a zeroed workspace. All contiguous.
ZGML_EXPORT int zgml_ffn(int kind, const float* h, const uint8_t* gu_qs, const void* gu_d,
                         const uint8_t* dn_qs, const void* dn_d, float* y, float* act,
                         unsigned int* bar, int M, int D, int F, void* stream) {
  if (M <= 0 || M > 32 || D <= 0 || F <= 0 || D % 32 != 0 || F % 32 != 0)
    return ZGML_ERR_SHAPE;
  if (kind != 0) return ZGML_ERR_KIND;
  const FfnPlanarParams p{h, gu_qs, static_cast<const __half*>(gu_d), dn_qs,
                          static_cast<const __half*>(dn_d), y, act, bar, M, D, F};
  const size_t smem = sizeof(float) * planar_smem_floats(M);
  const int items = D > F ? D : F;
  const int max_blocks = (items + FP_WARPS - 1) / FP_WARPS;
  return launch_cooperative(ffn_planar_kernel<FmtQ4_0>, FP_THREADS, smem, max_blocks, p,
                            static_cast<cudaStream_t>(stream));
}
