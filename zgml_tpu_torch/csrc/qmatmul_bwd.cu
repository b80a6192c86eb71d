// K11 qmatmul_bwd: dx[M, K] = g[M, N] @ dequant(W)[N, K], W in Q4_0 (K11q4)
// or Q8_0 (K11q8), f32 in and out: the input gradient of a projection whose
// quantized weight is frozen.
//
// Replaces: zgml_tpu/ops/qmatmul.py `_q8_bwd_kernel` (pallas_call at line
// 541) and `_q4_bwd_kernel` (pallas_call at line 593), reached through
// `_qmm_diff_bwd` when jax.grad differentiates `qmatmul_pallas`; the weight
// planes get no gradient. The JAX Q4_0 kernel writes dx as two half-K planes
// (lo | hi, the planar half-split); this one writes dx in logical k order.
//
// Weight layout: the port's N-major GGUF-order PackedWeight (quant/packed.py;
// block formats FmtQ4_0 / FmtQ8_0 of common.cuh): row n of W is contiguous
// along K, so the W tile [32 n rows x 128 k] of a stage is 4 quant blocks of
// each of 32 rows, one contiguous run of 64 (Q4_0) or 128 (Q8_0) bytes a row.
//
// What bounds it on the H100: the operations. At the training shape (M = 512
// rows of g, TinyLlama-1.1B) 2*M*N*K is 67 GFLOP at lm_head: 1.0 ms at the
// f32 CUDA-core rate, which cuBLAS' SGEMM reaches at ~72%; the bytes (g once,
// W once per 128-row tile of g, dx) take ~30 us.
//
// What the design does about it:
//  * Tensor cores, f32-class: mma.sync m16n8k8 TF32 with f32 accumulators.
//    The weight element is level * d with an integer level of at most 4
//    (Q4_0) or 8 (Q8_0) bits and an fp16 scale d of 11: each is a TF32 value
//    exactly, their product is not. So d goes to the other operand: for the
//    32 columns of quant block b, dx[m, 32b + j] = sum_n (g[m, n] * d[n, b]) *
//    level[n, 32b + j]. The levels are the B operand as they are; g * d is
//    split into hi = tf32_rna(fl32(g * d)) and lo = fl32(g * d - hi) (one
//    fma, the rest of the exact product), which the tensor cores read
//    truncated to TF32, leaving at most 2^-21 |g * d| behind, unbiased. Two
//    MMAs per tile (hi . level + lo . level), each product exact: the 3xTF32
//    idea with no third term, since the levels have no low part
//    (tests/test_torch_qmatmul_split.py).
//  * Tiles. A block of 8 warps owns a 128 (m) x 128 (k) tile of dx; warp
//    (wm, wk) owns rows 64 wm.. and the 32 columns of quant block wk, so its
//    A fragments take one scale per contraction row. N is stepped 32 rows a
//    stage through a ring of 3 cp.async stages (g [128 m x 32 n] f32 and the
//    32 rows' raw quant bytes, both in 16-byte copies). Each stage's levels
//    are unpacked once per block into a shared f32 plane, k-major (GGUF
//    nibble order), its 128 scales into a small table (each prefetched in a
//    register a stage ahead). g rows and plane rows are padded to 36 floats,
//    so each fragment load of a warp hits 32 distinct banks, as do the
//    unpack's plane stores (a warp's lanes on 32 rows).
//  * Short accumulation chains. The tensor cores round each MMA's sum toward
//    zero, and one chain over all of N (up to 32000 rows) drifts (as K3's
//    first version did). Each stage's 8 MMAs a tile (lo products first) go
//    into fresh accumulators, which join the running f32 sum in one
//    round-to-nearest add. With 64-row stages (16 MMAs, hi first) the error
//    at N 96 was 2.2-2.4x cuBLAS f32's (GPU test); joins inside a stage let
//    the compiler overlap two chains' accumulators and spill.
//  * Filling the card. At M 512 and K 2048 there are only 64 tiles for 132
//    SMs, so N is split into n_split parts (grid z), chosen by
//    ops/qmatmul.py qmatmul_bwd_plan from the tiles, the SM count and the
//    resident blocks per SM (zgml_qmatmul_bwd_blocks_per_sm). Part z takes
//    stages [z S / n_split, (z + 1) S / n_split) of the S = ceil(N / 32).
//    With n_split > 1 each part writes an f32 partial dx, and
//    tf32::sum_parts adds the parts in order 0, 1, ...: no atomics, so
//    dx has the same bits on every run. The grid runs k tiles fastest, so
//    the blocks that read one (m tile, part) slice of g run together and g
//    comes from HBM about once; W is read once per 128-row tile of g.
//  * Ragged edges: rows past M, n past N and quant blocks past K/32 are
//    zero-filled (scale 0) in the stage; a warp whose block is past K/32
//    computes and stores nothing. N % 4 != 0 (or a g not 16-byte aligned)
//    stages g with 4-byte copies.
#include "common.cuh"
#include "tf32_mma.cuh"

namespace {

using tf32::cp_async16;
using tf32::cp_async4;

// a block: 128 rows x 4 quant blocks of dx, 8 warps (2 along m, 4 along
// k), each 4 m16 fragments x one quant block; N in stages of 32 rows
constexpr int BM = 128, BKB = 4, BN = 32, STAGES = 3, WARPS_M = 2;
constexpr int MI = BM / 16 / WARPS_M;
constexpr int THREADS = 32 * WARPS_M * BKB;
constexpr int LDA = BN + 4;                    // floats per staged g row [m][n]
constexpr int LDW = BN + 4;                    // floats per level-plane row [k][n]

struct BwdParams {
  const float* g;
  const uint8_t* qs;
  const __half* d;
  float* out;        // dx, or with n_split > 1 the partials [n_split][M][K]
  int M, N, K, n_split;
};

template <class F>
constexpr size_t smem_bytes() {
  return (size_t)(STAGES * BM * LDA + BKB * 32 * LDW + BN * BKB) * sizeof(float) +
         (size_t)STAGES * BN * BKB * F::BYTES;
}

// Unpack half h (0, 1) of a quant block's levels from shared raw bytes into
// the k-major level plane, one contraction row n: element e of the block goes
// to dst[e * LDW] (GGUF order: Q4_0 bytes 8h..8h+7 hold elements 8h.. in
// their low nibbles and 16 + 8h.. in their high ones, Q8_0 bytes 16h..
// elements 16h..).
template <class F>
__device__ __forceinline__ void unpack_half(const uint8_t* blk, int h, float* dst) {
  if constexpr (F::KIND == 0) {
    const uint2 w = *reinterpret_cast<const uint2*>(blk + 8 * h);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t byte = ((i < 4 ? w.x : w.y) >> (8 * (i & 3))) & 0xFFu;
      dst[(8 * h + i) * LDW] = (float)((int)(byte & 15u) - 8);
      dst[(16 + 8 * h + i) * LDW] = (float)((int)(byte >> 4) - 8);
    }
  } else {
    const uint4 w = *reinterpret_cast<const uint4*>(blk + 16 * h);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      dst[(16 * h + i) * LDW] = (float)((int)(words[i >> 2] << (24 - 8 * (i & 3))) >> 24);
  }
}

// minBlocks 1: an explicit register budget, so ptxas does not trade spills
// for occupancy on its own
template <class F, bool G16>
__global__ void __launch_bounds__(THREADS, 1) qgemm_bwd_kernel(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int RAW_ROW = BKB * F::BYTES, RAW = BN * RAW_ROW;
  float* gs = reinterpret_cast<float*>(smem);           // [STAGES][BM][LDA]
  float* wf = gs + STAGES * BM * LDA;                   // [BKB * 32][LDW] levels, k-major
  float* sf = wf + BKB * 32 * LDW;                      // [BN][BKB] scales
  uint8_t* raw = reinterpret_cast<uint8_t*>(sf + BN * BKB);   // [STAGES][BN][RAW_ROW]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp / BKB, wk = warp % BKB;
  const int nblk = p.K / 32, kb0 = blockIdx.x * BKB, m0 = blockIdx.y * BM;
  const int n_stages = (p.N + BN - 1) / BN;
  const int st0 = (int)((long long)blockIdx.z * n_stages / p.n_split);
  const int st1 = (int)((long long)(blockIdx.z + 1) * n_stages / p.n_split);
  const int nst = st1 - st0;
  const bool live = kb0 + wk < nblk;                    // this warp's quant block exists
  // the unpack roles: UNPACK halves of quant blocks a thread; role u = tid +
  // v * THREADS is row u % BN of the stage, block u / BN / 2 of the tile, half
  // u / BN % 2 (a warp's lanes on 32 rows: its plane stores hit 32 banks)
  constexpr int UNPACK = BN * BKB * 2 / THREADS;

  auto copy_stage = [&](int st, int buf) {
    const int n0 = st * BN;
    float* ga = gs + buf * BM * LDA;
    if constexpr (G16) {
#pragma unroll
      for (int i = 0; i < BM * BN / 4 / THREADS; ++i) {
        const int c = tid + i * THREADS, r = c / (BN / 4), q = c % (BN / 4);
        const int m = m0 + r, n = n0 + 4 * q;
        const bool ok = m < p.M && n < p.N;
        cp_async16(ga + r * LDA + 4 * q, p.g + (ok ? (size_t)m * p.N + n : 0), ok);
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < BM * BN / THREADS; ++i) {
        const int c = tid + i * THREADS, r = c / BN, q = c % BN;
        const int m = m0 + r, n = n0 + q;
        const bool ok = m < p.M && n < p.N;
        cp_async4(ga + r * LDA + q, p.g + (ok ? (size_t)m * p.N + n : 0), ok);
      }
    }
    constexpr int CH = RAW_ROW / 16, PER_BLOCK = F::BYTES / 16;
    uint8_t* wr = raw + buf * RAW;
    for (int c = tid; c < BN * CH; c += THREADS) {
      const int r = c / CH, q = c % CH;
      const int n = n0 + r;
      const bool ok = n < p.N && kb0 + q / PER_BLOCK < nblk;
      cp_async16(wr + r * RAW_ROW + 16 * q,
                 p.qs + (ok ? ((size_t)n * nblk + kb0) * F::BYTES + 16 * q : 0), ok);
    }
    tf32::cp_async_commit();
  };
  auto scale_of = [&](int st, int v) -> float {
    const int u = tid + v * THREADS, n = st * BN + u % BN, kb = kb0 + u / BN / 2;
    return (st < st1 && n < p.N && kb < nblk) ? __half2float(p.d[(size_t)n * nblk + kb]) : 0.f;
  };

  float acc[MI][4][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nst) copy_stage(st0 + i, i);
    else tf32::cp_async_commit();
  }
  float sc[UNPACK];
#pragma unroll
  for (int v = 0; v < UNPACK; ++v) sc[v] = scale_of(st0, v);
  for (int it = 0; it < nst; ++it) {
    const int buf = it % STAGES;
    tf32::cp_async_wait<STAGES - 2>();
    __syncthreads();              // stage `it` landed; every warp is done with the planes
#pragma unroll
    for (int v = 0; v < UNPACK; ++v) {
      const int u = tid + v * THREADS, r = u % BN, b = u / BN / 2, h = u / BN % 2;
      unpack_half<F>(raw + buf * RAW + r * RAW_ROW + b * F::BYTES, h, wf + b * 32 * LDW + r);
      if (h == 0) sf[r * BKB + b] = sc[v];
      sc[v] = scale_of(st0 + it + 1, v);
    }
    __syncthreads();
    if (it + STAGES - 1 < nst) copy_stage(st0 + it + STAGES - 1, (it + STAGES - 1) % STAGES);
    else tf32::cp_async_commit();
    if (!live) continue;
    const float* ga = gs + buf * BM * LDA + wm * MI * 16 * LDA;
    const float* wb = wf + wk * 32 * LDW;
    float fr[MI][4][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) fr[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BN / 8; ++kk) {
      // k-step kk: 8 contraction rows; the scales of rows tig and tig + 4
      const float s0 = sf[(8 * kk + tig) * BKB + wk], s1 = sf[(8 * kk + tig + 4) * BKB + wk];
      uint32_t b[4][2], ah[MI][4], al[MI][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j][0] = __float_as_uint(wb[(8 * j + gid) * LDW + 8 * kk + tig]);
        b[j][1] = __float_as_uint(wb[(8 * j + gid) * LDW + 8 * kk + tig + 4]);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const float* a = ga + (16 * i + gid) * LDA + 8 * kk + tig;
        tf32::split_product(a[0], s0, ah[i][0], al[i][0]);
        tf32::split_product(a[8 * LDA], s0, ah[i][1], al[i][1]);
        tf32::split_product(a[4], s1, ah[i][2], al[i][2]);
        tf32::split_product(a[8 * LDA + 4], s1, ah[i][3], al[i][3]);
      }
      // the small lo products first, then the hi ones; all lo MMAs, then all
      // hi ones, so no MMA waits on the one before
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) tf32::mma_tf32(fr[i][j], al[i], b[j][0], b[j][1]);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) tf32::mma_tf32(fr[i][j], ah[i], b[j][0], b[j][1]);
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = __fadd_rn(acc[i][j][e], fr[i][j][e]);
  }
  tf32::cp_async_wait<0>();
  if (!live) return;
  float* out = p.out + (size_t)blockIdx.z * p.M * p.K;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int r0 = m0 + (wm * MI + i) * 16 + gid;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = (kb0 + wk) * 32 + 8 * j + 2 * tig;
      if (r0 < p.M)
        *reinterpret_cast<float2*>(out + (size_t)r0 * p.K + col) =
            make_float2(acc[i][j][0], acc[i][j][1]);
      if (r0 + 8 < p.M)
        *reinterpret_cast<float2*>(out + (size_t)(r0 + 8) * p.K + col) =
            make_float2(acc[i][j][2], acc[i][j][3]);
    }
  }
}

template <class F, bool G16>
int launch(const BwdParams& p, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<F>();
  int rc = allow_dynamic_smem(qgemm_bwd_kernel<F, G16>, smem);
  if (rc != 0) return rc;
  const dim3 grid((p.K / 32 + BKB - 1) / BKB, (p.M + BM - 1) / BM, p.n_split);
  qgemm_bwd_kernel<F, G16><<<grid, THREADS, smem, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// *n = the blocks of the kind's K11 kernel one SM holds at once (the
// occupancy ops/qmatmul.py qmatmul_bwd_plan fills); returns a status.
ZGML_EXPORT int zgml_qmatmul_bwd_blocks_per_sm(int kind, int* n) {
  ZGML_DISPATCH_KIND(kind, {
    constexpr size_t smem = smem_bytes<F>();
    const int rc = allow_dynamic_smem(qgemm_bwd_kernel<F, true>, smem);
    if (rc != 0) return rc;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, qgemm_bwd_kernel<F, true>,
                                                              THREADS, smem);
  })
}

// kind 0 (q4_0) or 1 (q8_0); g f32 [M, N], qs [N, K/32 * BYTES], d fp16
// [N, K/32] -> dx f32 [M, K], all contiguous, qs and dx 16-byte aligned, on
// `stream`. n_split (1 <= n_split <= ceil(N / 32)) from ops/qmatmul.py
// qmatmul_bwd_plan; with n_split > 1, part is f32 scratch of n_split * M * K
// (16-byte aligned).
ZGML_EXPORT int zgml_qmatmul_bwd(int kind, const float* g, const uint8_t* qs, const void* d,
                                 float* dx, float* part, int M, int N, int K, int n_split,
                                 void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 != 0 || n_split < 1 || n_split > 65535 ||
      n_split > (N + BN - 1) / BN || (n_split > 1 && part == nullptr) ||
      (M + BM - 1) / BM > 65535)
    return ZGML_ERR_SHAPE;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BwdParams p{g, qs, static_cast<const __half*>(d), n_split > 1 ? part : dx, M, N, K,
                    n_split};
  const bool g16 = N % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  int rc = 0;
  ZGML_DISPATCH_KIND(kind, {
    rc = g16 ? launch<F, true>(p, st) : launch<F, false>(p, st);
    break;
  })
  if (rc != 0 || n_split == 1) return rc;
  return tf32::sum_parts(part, dx, (long long)M * K, n_split, st);
}
