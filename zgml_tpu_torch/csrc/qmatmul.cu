// K2 qmatmul: y[M, N] = x[M, K] @ dequant(W)^T, W in Q4_0 (K2q4) or Q8_0
// (K2q8), f32 in and out; and its bf16 form, y = sum_k bf16(x) *
// bf16(level * d) with f32 sums (JAX's dot_bf16, qmatmul.py:57-63, 113-121,
// which ZGML_TPU_PREFILL_BF16, on by default, selects for row tiles of 32
// rows or more; ops/qmatmul.py bf16_tier).
//
// Replaces: zgml_tpu/ops/qmatmul.py `_q4_kernel` (pallas_call at line 141)
// and `_q8_kernel` (pallas_call at line 81), reached through `_q4_matmul` /
// `_q8_matmul` from `qmatmul_pallas`; on the TPU they serve every M when the
// int8-activation tier is off (ZGML_TPU_I8DOT=0) and M > 32 when it is on
// (prefill chunks, training's forward at M 512).
//
// Weight layout (zgml_tpu_torch/quant/packed.py; the block formats are the
// FmtQ4_0 / FmtQ8_0 traits of common.cuh): N-major, GGUF block order, qs
// [N, K/32 * BYTES] (16 bytes of nibbles or 32 int8 per block) and d fp16
// [N, K/32]; value = level * d.
//
// What bounds it on the H100:
//   * M <= 4 (decode, the greedy head): a GEMV. Every weight byte is read once
//     per row of x, so it is bound by HBM bandwidth (0.5625 bytes per weight
//     at Q4_0, 1.0625 at Q8_0, at 3.35 TB/s).
//   * M > 4 (prefill chunks of 128 rows, training's 512): 2*M*N*K operations
//     over the same bytes, bound by the tensor cores. f32-class products on
//     them take two TF32 passes (below): 4*M*N*K at 495 TFLOP/s, 7.4x less
//     time than the f32 rate of the CUDA cores (67 TFLOP/s). Below 128 rows the tile's rows past M still take their MMAs
//     (zeros), so M 5-32 (the I8DOT=0 path's small calls) costs about what a
//     chunk's 128 rows cost.
//
// What the design does about it:
//   * GEMV (M <= 4): one warp per output row; lane l reads whole blocks l,
//     l+32, ... (16 or 32 bytes, as one or two 16-byte loads) so a warp's
//     load is 512 or 1024 contiguous bytes; x is staged once per block in
//     shared memory with one padding word per 32 floats, so the 32 lanes
//     (each in its own block) hit 32 distinct banks. The level sum of a block
//     is taken in f32, then scaled once by d.
//   * Tiled (M > 4): split-TF32 `wgmma` (sm_90a). Every Q4_0 level (-8..7)
//     and Q8_0 level (-127..127) is a TF32 value, so the levels go to the
//     tensor cores unchanged as the B operand, from shared memory through a
//     descriptor. level * d is not (up to 15 significant bits), so the scale
//     d[n, kb] stays out of the MMAs: it sits on the contraction side and
//     cannot fold into x either. x is the A operand, in registers, split
//     as hi = rna(x), lo = rna(x - hi) (tf32::split_tf32), which leaves at
//     most 2^-22 |x| behind; every product is exact. Each quant block's 8
//     MMAs (4 k8 steps, the lo products first, then the hi ones) go into a
//     fresh accumulator (scale-d 0 on the first), which joins the running
//     f32 sum in one round-to-nearest fmaf(d[n, kb], blk, acc). So the
//     tensor cores' round-toward-zero acts on chains of 8 MMAs only
//     (tests/test_torch_qmatmul_fwd_split.py emulates it).
//   * Tiles and roles: a block owns 128 rows of x by 128 weight rows and
//     runs three warpgroups. Two consume: each owns 64 rows (one
//     m64n128k8 per MMA) and keeps the running sum, the block accumulator
//     and its split x fragments in registers (setmaxnreg gives them
//     CONSUMER_REGS and takes the producer down to PRODUCER_REGS). One
//     produces: K steps one quant block (32 k) a stage through a ring of
//     STAGES stages; producer thread r copies x's chunks and weight row r's
//     raw block bytes of a stage with cp.async (x f32 [128 x 32], rows padded
//     to 36 floats so the consumers' A fragment loads hit 32 banks), then
//     expands its own row into the stage's f32 level tile: one quant block
//     of one weight row is exactly one 128-byte row of the 128-byte swizzle
//     `wgmma` reads (16-byte chunk c of row n at c ^ (n % 8)), a byte turned
//     into a float by a byte permute and one subtract (no I2F), and writes
//     the row's scale, which it loaded a stage ahead. Stages pass through
//     two mbarriers each (full: the producer's copies and expansion are
//     done; empty: both consumers are done), with no block-wide barrier, so
//     the consumers drift out of step and one's split and join overlap the
//     other's MMAs.
//     What bounds a stage: shared memory carries the levels to the tensor
//     cores twice (hi and lo, 64 B a clock at the full TF32 rate), x in and
//     out and the expanded levels in; at the full TF32 rate that is ~90% of
//     its 128 B a clock (PERF.md).
//   * Filling the card: at a prefill chunk there are only 16-250 tiles of
//     128 x 128 for 132 SMs, so K is split into n_split parts of whole
//     quant blocks (grid z), chosen by ops/qmatmul.py qmatmul_plan from the
//     tiles, the SM count, the resident blocks per SM
//     (zgml_qmatmul_blocks_per_sm) and the partials' traffic. With
//     n_split > 1 each part writes an f32 partial y and tf32::sum_parts adds
//     the parts in order 0, 1, ...: no atomics, so y has the same bits on
//     every run.
//   * Edges: rows past M, weight rows past N and quant blocks past a part's
//     end are staged as zeros (scale 0) and never stored; K % 32 == 0.
//
// The bf16 form (bf16 != 0):
//   * What bounds it: 2*M*N*K operations on bf16 tensor cores at 989
//     TFLOP/s, one product per dot (TF32 takes two at half the rate).
//   * GEMV (M <= 4, the prefill head's row at a 128-row chunk): the f32
//     GEMV with x staged rounded to bf16 and each weight element taken as
//     bf16(level * d) (level * d is exact in f32 and rounds once, as JAX's
//     w.astype(bf16)); the products of two bf16 values are exact in f32,
//     the sums f32.
//   * Tiled (M > 4): a pre-pass (round_bf16_kernel) rounds x to bf16 once
//     into the caller's scratch, so no tile rounds it again. The GEMM keeps
//     the f32 kernel's roles, tiles and barriers with a stage of two quant
//     blocks (64 k): the producer thread r copies row r of the stage's bf16
//     x (128 bytes) and weight row r's raw bytes with cp.async, then
//     expands its weight row into bf16(level * d) (the scale goes into the
//     weight before the rounding, so the f32 form's exact levels with the scale
//     outside the MMAs do not apply), both tiles in the 128-byte swizzle.
//     A and B both come from shared memory through descriptors: each
//     consumer warpgroup runs 4 m64n128k16 bf16 MMAs a stage into a fresh
//     accumulator, which joins the running f32 sum in one add on the CUDA
//     cores (no tensor-core chain is longer than 4 MMAs). A stage is 37 KB
//     (Q4_0) or 41 KB (Q8_0) for 64 k, against the f32 form's 40 KB for 32
//     k, so the ring holds 6 or 5 stages: 384 or 320 k in flight.
#include "common.cuh"
#include "tf32_mma.cuh"

namespace {

using tf32::cp_async16;

constexpr int GEMV_WARPS = 8;   // output rows per GEMV block
constexpr int GEMV_MAX_M = 4;   // M above this runs the tiled kernel

// the tiled kernel: 128 x 128 output tiles, two consumer warpgroups of 64
// rows and one producer warpgroup, one quant block (32 k) a stage
constexpr int BM = 128, BN = 128, STAGES = 5;
constexpr int CONSUMERS = 256, THREADS = CONSUMERS + 128;
constexpr int LDX = 32 + 4;                       // floats per staged x row
constexpr int LEVEL_TILE = BN * 32 * 4;           // bytes: 128 rows x 128 bytes
// registers a thread after setmaxnreg (128 * 72 + 256 * 208 <= 65536)
constexpr int PRODUCER_REGS = 72, CONSUMER_REGS = 208;

// a stage: the level tile (1024-byte aligned for the swizzle), x [BM][LDX]
// f32, the raw block bytes [BN][BYTES] and the scales [BN] f32
template <class F>
__host__ __device__ constexpr int stage_bytes() {
  return (LEVEL_TILE + BM * LDX * 4 + BN * F::BYTES + BN * 4 + 1023) / 1024 * 1024;
}
template <class F>
constexpr size_t gemm_smem_bytes() {
  return 1024 /* alignment */ + (size_t)STAGES * stage_bytes<F>() + 2 * STAGES * 8 /* barriers */;
}

// v rounded to bf16 (to nearest even), as an f32
__device__ __forceinline__ float bf16_rn(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// BF16: the bf16 form (x staged rounded, each weight element bf16(level * d))
template <class F, bool BF16>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
qgemv_kernel(const float* __restrict__ x, const uint8_t* __restrict__ qs,
             const __half* __restrict__ d, float* __restrict__ y, int N, int K) {
  extern __shared__ float xs[];   // [K/32][33]
  const int m = blockIdx.y;
  const int nblk = K / 32;
  const float* xm = x + (size_t)m * K;
  for (int i = threadIdx.x; i < K; i += blockDim.x)
    xs[(i >> 5) * 33 + (i & 31)] = BF16 ? bf16_rn(xm[i]) : xm[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * GEMV_WARPS + warp;
  if (n >= N) return;
  const uint8_t* row[1] = {qs + (size_t)n * nblk * F::BYTES};
  const __half* drow[1] = {d + (size_t)n * nblk};
  float acc[1];
  if constexpr (BF16) {
    // exact products of two bf16 values, f32 sums
    acc[0] = 0.f;
    for (int b = lane; b < nblk; b += 32) {
      uint32_t w[F::WORDS];
      load_block<F>(row[0], b, w);
      const float dv = __half2float(drow[0][b]);
      const float* xb = xs + b * 33;
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < 32; ++t)
        sum = fmaf(bf16_rn(F::level(w, F::elem(t)) * dv), xb[F::elem(t)], sum);
      acc[0] += sum;
    }
  } else {
    rows_f32<F, 1>(row, drow, xs, nblk, lane, acc);
  }
  const float s = warp_sum(acc[0]);
  if (lane == 0) y[(size_t)m * N + n] = s;
}

// xb[i] = bf16(x[i]) (to nearest even): the bf16 GEMM's pre-pass, n % 4 == 0
__global__ void round_bf16_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ xb,
                                  long long n4) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4; i += stride) {
    const float4 v = reinterpret_cast<const float4*>(x)[i];
    reinterpret_cast<uint2*>(xb)[i] =
        make_uint2(tf32::pack_bf16x2(v.x, v.y), tf32::pack_bf16x2(v.z, v.w));
  }
}

// ---- mbarriers, wgmma (sm_90a) ---------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(tf32::smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(tf32::smem_u32(bar)) : "memory");
}
// wait until the phase of parity `parity` of *bar has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(tf32::smem_u32(bar)), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving reads or writes of r across the start or the
// wait of an async MMA (the accumulator is written until wgmma_wait_all)
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// the shared-memory descriptor of a K-major operand in the 128-byte swizzle:
// 8-row atoms of 128-byte rows, 1024 bytes apart (SBO); the leading offset is
// unused when one MMA's 32 bytes of k lie inside a row; `addr` must keep the
// atom's 1024-byte alignment apart from the k offset (base offset 0)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

#define ZGML_ACC8(i)                                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),         \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= a . b on a 64 x 128 x 8 TF32 tile: a from registers (the m16n8k8
// A fragment of this warp's 16 rows), b through its descriptor; f32
// accumulators, overwritten when accumulate is 0. Asynchronous: d and a stay
// untouched until wgmma_wait_all.
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64], const uint32_t (&a)[4],
                                                     uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : ZGML_ACC8(0), ZGML_ACC8(8), ZGML_ACC8(16), ZGML_ACC8(24), ZGML_ACC8(32), ZGML_ACC8(40),
        ZGML_ACC8(48), ZGML_ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}
// d (+)= a . b on a 64 x 128 x 16 bf16 tile, both operands K-major in
// shared memory through their descriptors; f32 accumulators, overwritten
// when accumulate is 0. Asynchronous as the TF32 one.
__device__ __forceinline__ void wgmma_m64n128k16_bf16(float (&d)[64], uint64_t a, uint64_t b,
                                                      int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : ZGML_ACC8(0), ZGML_ACC8(8), ZGML_ACC8(16), ZGML_ACC8(24), ZGML_ACC8(32), ZGML_ACC8(40),
        ZGML_ACC8(48), ZGML_ACC8(56)
      : "l"(a), "l"(b), "r"(accumulate));
}
#undef ZGML_ACC8

// the four bytes bb of w (each 0..255), byte 0 first, as exact floats minus
// `bias`: 0x4B0000bb is 2^23 + bb as an f32
__device__ __forceinline__ float4 bytes_to_float4(uint32_t w, float bias) {
  return make_float4(__uint_as_float(__byte_perm(w, 0x4B00u, 0x5440u)) - bias,
                     __uint_as_float(__byte_perm(w, 0x4B00u, 0x5441u)) - bias,
                     __uint_as_float(__byte_perm(w, 0x4B00u, 0x5442u)) - bias,
                     __uint_as_float(__byte_perm(w, 0x4B00u, 0x5443u)) - bias);
}

// Expand row r of a stage's raw block bytes into the level tile: its 32
// levels (GGUF order: Q4_0 byte j holds element j in its low nibble and
// j + 16 in its high one; Q8_0 byte j element j) as 8 chunks of 4 floats,
// chunk c at c ^ (r % 8) of the row's 128 bytes (the 128-byte swizzle).
template <class F>
__device__ __forceinline__ void expand_row(const uint8_t* raw, unsigned char* tile, int r) {
  uint32_t w[8];
  float bias;
  if constexpr (F::KIND == 0) {
    const uint4 v = *reinterpret_cast<const uint4*>(raw + r * F::BYTES);
    const uint32_t vw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = vw[i] & 0x0F0F0F0Fu;
      w[4 + i] = (vw[i] >> 4) & 0x0F0F0F0Fu;
    }
    bias = 8388608.f + 8.f;              // nibble n is level n - 8
  } else {
    const uint4* v = reinterpret_cast<const uint4*>(raw + r * F::BYTES);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 u = v[h];
      w[4 * h] = u.x ^ 0x80808080u;      // int8 b as b + 128
      w[4 * h + 1] = u.y ^ 0x80808080u;
      w[4 * h + 2] = u.z ^ 0x80808080u;
      w[4 * h + 3] = u.w ^ 0x80808080u;
    }
    bias = 8388608.f + 128.f;
  }
  unsigned char* row = tile + r * 128;
#pragma unroll
  for (int c = 0; c < 8; ++c)
    *reinterpret_cast<float4*>(row + ((c ^ (r & 7)) << 4)) = bytes_to_float4(w[c], bias);
}

// Store a consumer's m64n128 accumulator: acc[4j + e] is row m (+8 for
// e >= 2), column n0 + 8j + 2 tig (+1 for odd e) of out [M, N].
__device__ __forceinline__ void store_tile(const float (&acc)[64], float* out, int M, int N, int m,
                                           int n0, int tig) {
  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (m + 8 * h >= M) continue;
    float* yr = out + (size_t)(m + 8 * h) * N;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + 8 * j + 2 * tig;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (pairs && n + 1 < N) {
        *reinterpret_cast<float2*>(yr + n) = make_float2(v0, v1);
      } else {
        if (n < N) yr[n] = v0;
        if (n + 1 < N) yr[n + 1] = v1;
      }
    }
  }
}

struct GemmParams {
  const float* x;
  const uint8_t* qs;
  const __half* d;
  float* out;        // y, or with n_split > 1 the partials [n_split][M][N]
  int M, N, K, n_split;
};

// Warp-specialized: warpgroup 2 produces, warpgroups 0 and 1 consume, each
// stage handed over through two mbarriers (full: the producer's 128 threads
// copied and expanded it; empty: the consumers' 256 threads are done with
// it), so the consumers run out of step and one's join overlaps the other's
// MMAs.
template <class F>
__global__ void __launch_bounds__(THREADS, 1) qgemm_tf32_kernel(const GemmParams p) {
  constexpr int SB = stage_bytes<F>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (tf32::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * SB);
  uint64_t* empty = full + STAGES;
  // stage s's parts: levels at 0, then x, raw and the scales
  auto levels_of = [&](int s) { return smem + (s % STAGES) * SB; };
  auto x_of = [&](int s) { return reinterpret_cast<float*>(levels_of(s) + LEVEL_TILE); };
  auto raw_of = [&](int s) { return reinterpret_cast<uint8_t*>(x_of(s) + BM * LDX); };
  auto sf_of = [&](int s) { return reinterpret_cast<float*>(raw_of(s) + BN * F::BYTES); };

  const int t = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int nblk = p.K / 32;
  const int b0 = (int)((long long)blockIdx.z * nblk / p.n_split);
  const int b1 = (int)((long long)(blockIdx.z + 1) * nblk / p.n_split);
  const int nst = b1 - b0;
  if (t == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + i, THREADS - CONSUMERS);
      mbar_init(empty + i, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the warpgroup's index, uniform to the compiler (so wgmma is not on a
  // divergent path and is not serialized)
  const int wg = __shfl_sync(0xFFFFFFFFu, t >> 7, 0);

  if (wg == 2) {
    // producer: thread r copies x's chunks r, r + 128, ... and weight row r's
    // raw bytes of a stage, then expands that row itself (its own copies)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int r = t - CONSUMERS;
    const bool row_ok = n0 + r < p.N;
    const uint8_t* wrow = p.qs + (size_t)(row_ok ? n0 + r : 0) * nblk * F::BYTES;
    const __half* drow = p.d + (size_t)(row_ok ? n0 + r : 0) * nblk;
    auto copy_stage = [&](int s) {
      const int kb = b0 + s;
      float* xa = x_of(s);
#pragma unroll
      for (int v = 0; v < BM * 8 / 128; ++v) {         // 8 float4 a row of x
        const int c = r + v * 128, xr = c >> 3, q = c & 7;
        const bool ok = m0 + xr < p.M;
        cp_async16(xa + xr * LDX + 4 * q,
                   p.x + (ok ? (size_t)(m0 + xr) * p.K + kb * 32 + 4 * q : 0), ok);
      }
#pragma unroll
      for (int q = 0; q < F::BYTES / 16; ++q)
        cp_async16(raw_of(s) + r * F::BYTES + 16 * q, wrow + (size_t)kb * F::BYTES + 16 * q,
                   row_ok);
    };
    auto scale_of = [&](int s) -> float {
      return (s < nst && row_ok) ? __half2float(drow[b0 + s]) : 0.f;
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nst) copy_stage(s);
      tf32::cp_async_commit();
    }
    float sc = scale_of(0);
    for (int s = 0; s < nst; ++s) {
      tf32::cp_async_wait<STAGES - 2>();       // stage s's copies (this thread's) landed
      expand_row<F>(raw_of(s), levels_of(s), r);
      sf_of(s)[r] = sc;
      sc = scale_of(s + 1);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(full + s % STAGES);
      // stage s + STAGES - 1 into the slot of stage s - 1, once it is consumed
      const int sn = s + STAGES - 1;
      if (sn < nst) {
        if (s >= 1) mbar_wait(empty + (s - 1) % STAGES, ((s - 1) / STAGES) & 1);
        copy_stage(sn);
      }
      tf32::cp_async_commit();
    }
    tf32::cp_async_wait<0>();
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg.. of the tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int warp = (t >> 5) & 3, lane = t & 31, gid = lane >> 2, tig = lane & 3;
  const int xr = 64 * wg + 16 * warp + gid;      // this thread's A fragment rows xr, xr + 8
  float acc[64], blk[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = blk[i] = 0.f;
  uint32_t ah[4][4], al[4][4];
  for (int s = 0; s < nst; ++s) {
    mbar_wait(full + s % STAGES, (s / STAGES) & 1);
    const float* xa = x_of(s) + xr * LDX + tig;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      tf32::split_tf32(xa[8 * kk], ah[kk][0], al[kk][0]);
      tf32::split_tf32(xa[8 * LDX + 8 * kk], ah[kk][1], al[kk][1]);
      tf32::split_tf32(xa[8 * kk + 4], ah[kk][2], al[kk][2]);
      tf32::split_tf32(xa[8 * LDX + 8 * kk + 4], ah[kk][3], al[kk][3]);
    }
    const uint64_t desc = sw128_desc(tf32::smem_u32(levels_of(s)));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_m64n128k8_tf32(blk, al[kk], desc + 2 * kk, kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_m64n128k8_tf32(blk, ah[kk], desc + 2 * kk, 1);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < 64; ++i) fence_operand(blk[i]);
    const float* sf = sf_of(s) + 2 * tig;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 dj = *reinterpret_cast<const float2*>(sf + 8 * j);
      acc[4 * j] = __fmaf_rn(dj.x, blk[4 * j], acc[4 * j]);
      acc[4 * j + 1] = __fmaf_rn(dj.y, blk[4 * j + 1], acc[4 * j + 1]);
      acc[4 * j + 2] = __fmaf_rn(dj.x, blk[4 * j + 2], acc[4 * j + 2]);
      acc[4 * j + 3] = __fmaf_rn(dj.y, blk[4 * j + 3], acc[4 * j + 3]);
    }
    mbar_arrive(empty + s % STAGES);
  }
  store_tile(acc, p.out + (size_t)blockIdx.z * p.M * p.N, p.M, p.N, m0 + xr, n0, tig);
}

// ---- the bf16 form's GEMM ----------------------------------------------------

// a stage of 64 k: the bf16 x tile and the bf16 weight tile (each 128 rows of
// 128 bytes in the 128-byte swizzle, 1024-byte aligned), the raw block bytes
// [BN][2 * BYTES] and the scales [BN][2] f32
constexpr int BF16_TILE = 128 * 128;               // bytes of either tile
template <class F>
__host__ __device__ constexpr int stage_bytes_bf16() {
  return (2 * BF16_TILE + BN * 2 * F::BYTES + BN * 2 * 4 + 1023) / 1024 * 1024;
}
template <class F>
__host__ __device__ constexpr int stages_bf16() {   // 6 at Q4_0, 5 at Q8_0
  return (227 * 1024 - 2048) / stage_bytes_bf16<F>() < 6 ? 5 : 6;
}
template <class F>
constexpr size_t gemm_bf16_smem_bytes() {
  return 1024 + (size_t)stages_bf16<F>() * stage_bytes_bf16<F>() + 2 * stages_bf16<F>() * 8;
}

struct GemmBf16Params {
  const __nv_bfloat16* xb;   // bf16(x) [M, K], from round_bf16_kernel
  const uint8_t* qs;
  const __half* d;
  float* out;                // y, or with n_split > 1 the partials [n_split][M][N]
  int M, N, K, n_split;
};

// Expand weight row r of a stage's raw bytes (two quant blocks, the second
// zero where the part ends) into the bf16 tile: element e (block e / 32)
// is bf16(level * d[block]); 16-byte chunk c (elements 8c .. 8c + 7) at
// c ^ (r % 8) of the row's 128 bytes.
template <class F>
__device__ __forceinline__ void expand_row_bf16(const uint8_t* raw, const float* sc,
                                                unsigned char* tile, int r) {
  unsigned char* row = tile + r * 128;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t w[8];
    float bias;
    const uint8_t* src = raw + (r * 2 + h) * F::BYTES;
    if constexpr (F::KIND == 0) {
      const uint4 v = *reinterpret_cast<const uint4*>(src);
      const uint32_t vw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        w[i] = vw[i] & 0x0F0F0F0Fu;            // elements 4i .. 4i + 3
        w[4 + i] = (vw[i] >> 4) & 0x0F0F0F0Fu; // elements 16 + 4i ..
      }
      bias = 8388608.f + 8.f;
    } else {
      const uint4* v = reinterpret_cast<const uint4*>(src);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const uint4 u = v[q];
        w[4 * q] = u.x ^ 0x80808080u;
        w[4 * q + 1] = u.y ^ 0x80808080u;
        w[4 * q + 2] = u.z ^ 0x80808080u;
        w[4 * q + 3] = u.w ^ 0x80808080u;
      }
      bias = 8388608.f + 128.f;
    }
    const float dv = sc[r * 2 + h];
#pragma unroll
    for (int c = 0; c < 4; ++c) {            // chunk 4h + c: elements 8c .. 8c + 7 of block h
      const float4 a = bytes_to_float4(w[2 * c], bias), b = bytes_to_float4(w[2 * c + 1], bias);
      const uint4 o = make_uint4(tf32::pack_bf16x2(a.x * dv, a.y * dv),
                                 tf32::pack_bf16x2(a.z * dv, a.w * dv),
                                 tf32::pack_bf16x2(b.x * dv, b.y * dv),
                                 tf32::pack_bf16x2(b.z * dv, b.w * dv));
      *reinterpret_cast<uint4*>(row + (((4 * h + c) ^ (r & 7)) << 4)) = o;
    }
  }
}

// The bf16 form above 4 rows: qgemm_tf32_kernel's roles and barriers, a
// stage of two quant blocks, A (bf16 x) and B (bf16 weights) both through
// shared-memory descriptors.
template <class F>
__global__ void __launch_bounds__(THREADS, 1) qgemm_bf16_kernel(const GemmBf16Params p) {
  constexpr int SB = stage_bytes_bf16<F>(), ST = stages_bf16<F>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (tf32::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ST * SB);
  uint64_t* empty = full + ST;
  // stage s's parts: the x tile at 0, the weight tile, then raw and the scales
  auto xt_of = [&](int s) { return smem + (s % ST) * SB; };
  auto wt_of = [&](int s) { return xt_of(s) + BF16_TILE; };
  auto raw_of = [&](int s) { return reinterpret_cast<uint8_t*>(wt_of(s) + BF16_TILE); };
  auto sf_of = [&](int s) { return reinterpret_cast<float*>(raw_of(s) + BN * 2 * F::BYTES); };

  const int t = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int nblk = p.K / 32;
  const int b0 = (int)((long long)blockIdx.z * nblk / p.n_split);
  const int b1 = (int)((long long)(blockIdx.z + 1) * nblk / p.n_split);
  const int nst = (b1 - b0 + 1) / 2;
  if (t == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(full + i, THREADS - CONSUMERS);
      mbar_init(empty + i, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = __shfl_sync(0xFFFFFFFFu, t >> 7, 0);

  if (wg == 2) {
    // producer: thread r copies row r of the stage's x and weight row r's raw
    // bytes, then expands that weight row itself (its own copies)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int r = t - CONSUMERS;
    const bool row_ok = n0 + r < p.N, x_ok = m0 + r < p.M;
    const uint8_t* wrow = p.qs + (size_t)(row_ok ? n0 + r : 0) * nblk * F::BYTES;
    const __half* drow = p.d + (size_t)(row_ok ? n0 + r : 0) * nblk;
    const __nv_bfloat16* xrow = p.xb + (size_t)(x_ok ? m0 + r : 0) * p.K;
    auto copy_stage = [&](int s) {
      const int kb = b0 + 2 * s;
      const bool two = kb + 1 < b1;
      unsigned char* xt = xt_of(s) + r * 128;
#pragma unroll
      for (int q = 0; q < 8; ++q) {                  // 8 bf16 a chunk
        const bool ok = x_ok && (q < 4 || two);
        cp_async16(xt + ((q ^ (r & 7)) << 4), xrow + (ok ? (size_t)kb * 32 + 8 * q : 0), ok);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < F::BYTES / 16; ++q)
          cp_async16(raw_of(s) + (r * 2 + h) * F::BYTES + 16 * q,
                     wrow + (size_t)(kb + h) * F::BYTES + 16 * q, row_ok && (h == 0 || two));
    };
    auto scale_of = [&](int s, int h) -> float {
      const int kb = b0 + 2 * s + h;
      return (s < nst && row_ok && kb < b1) ? __half2float(drow[kb]) : 0.f;
    };
#pragma unroll
    for (int s = 0; s < ST - 1; ++s) {
      if (s < nst) copy_stage(s);
      tf32::cp_async_commit();
    }
    float sc0 = scale_of(0, 0), sc1 = scale_of(0, 1);
    for (int s = 0; s < nst; ++s) {
      tf32::cp_async_wait<ST - 2>();           // stage s's copies (this thread's) landed
      float* sf = sf_of(s);
      sf[2 * r] = sc0;
      sf[2 * r + 1] = sc1;
      expand_row_bf16<F>(raw_of(s), sf, wt_of(s), r);
      sc0 = scale_of(s + 1, 0);
      sc1 = scale_of(s + 1, 1);
      // the x tile (cp.async, generic proxy) and the weight tile reach wgmma's
      // async proxy through this fence and the barrier
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(full + s % ST);
      const int sn = s + ST - 1;
      if (sn < nst) {
        if (s >= 1) mbar_wait(empty + (s - 1) % ST, ((s - 1) / ST) & 1);
        copy_stage(sn);
      }
      tf32::cp_async_commit();
    }
    tf32::cp_async_wait<0>();
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg.. of the tile (x tile rows 64 wg..,
  // 8 swizzle atoms of 1024 bytes in)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int warp = (t >> 5) & 3, lane = t & 31, gid = lane >> 2, tig = lane & 3;
  const int xr = 64 * wg + 16 * warp + gid;      // this thread's accumulator rows xr, xr + 8
  float acc[64], blk[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = blk[i] = 0.f;
  for (int s = 0; s < nst; ++s) {
    mbar_wait(full + s % ST, (s / ST) & 1);
    const uint64_t da = sw128_desc(tf32::smem_u32(xt_of(s)) + wg * 64 * 128);
    const uint64_t db = sw128_desc(tf32::smem_u32(wt_of(s)));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_m64n128k16_bf16(blk, da + 2 * kk, db + 2 * kk, kk > 0);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < 64; ++i) fence_operand(blk[i]);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], blk[i]);
    mbar_arrive(empty + s % ST);
  }
  store_tile(acc, p.out + (size_t)blockIdx.z * p.M * p.N, p.M, p.N, m0 + xr, n0, tig);
}

template <class F, bool BF16>
int launch_gemv(const float* x, const uint8_t* qs, const __half* d, float* y, int M, int N,
                int K, cudaStream_t st) {
  const size_t smem = (size_t)(K / 32) * 33 * sizeof(float);
  const int rc = allow_dynamic_smem(qgemv_kernel<F, BF16>, smem);
  if (rc != 0) return rc;
  const dim3 grid((N + GEMV_WARPS - 1) / GEMV_WARPS, M);
  qgemv_kernel<F, BF16><<<grid, GEMV_WARPS * 32, smem, st>>>(x, qs, d, y, N, K);
  return (int)cudaGetLastError();
}

template <class F>
int launch(const float* x, const uint8_t* qs, const __half* d, float* y, float* part,
           __nv_bfloat16* xb, int M, int N, int K, int n_split, bool bf16, cudaStream_t st) {
  if (M <= GEMV_MAX_M)
    return bf16 ? launch_gemv<F, true>(x, qs, d, y, M, N, K, st)
                : launch_gemv<F, false>(x, qs, d, y, M, N, K, st);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, n_split);
  float* out = n_split > 1 ? part : y;
  int rc;
  if (bf16) {
    const long long n4 = (long long)M * K / 4;
    const long long blocks = n4 / 256 + 1;
    round_bf16_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, st>>>(x, xb, n4);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    constexpr size_t smem = gemm_bf16_smem_bytes<F>();
    rc = allow_dynamic_smem(qgemm_bf16_kernel<F>, smem);
    if (rc != 0) return rc;
    qgemm_bf16_kernel<F><<<grid, THREADS, smem, st>>>(GemmBf16Params{xb, qs, d, out, M, N, K,
                                                                      n_split});
  } else {
    constexpr size_t smem = gemm_smem_bytes<F>();
    rc = allow_dynamic_smem(qgemm_tf32_kernel<F>, smem);
    if (rc != 0) return rc;
    qgemm_tf32_kernel<F><<<grid, THREADS, smem, st>>>(GemmParams{x, qs, d, out, M, N, K,
                                                                 n_split});
  }
  rc = (int)cudaGetLastError();
  if (rc != 0 || n_split == 1) return rc;
  return tf32::sum_parts(part, y, (long long)M * N, n_split, st);
}

template <class K>
int occupancy(K kernel, size_t smem, int* n) {
  const int rc = allow_dynamic_smem(kernel, smem);
  if (rc != 0) return rc;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, kernel, THREADS, smem);
}

}  // namespace

// *n = the blocks of the kind's tiled K2 kernel one SM holds at once (the
// occupancy ops/qmatmul.py qmatmul_plan fills); returns a status.
ZGML_EXPORT int zgml_qmatmul_blocks_per_sm(int kind, int* n) {
  ZGML_DISPATCH_KIND(kind, return occupancy(qgemm_tf32_kernel<F>, gemm_smem_bytes<F>(), n))
}

// The same for the bf16 form's GEMM.
ZGML_EXPORT int zgml_qmatmul_bf16_blocks_per_sm(int kind, int* n) {
  ZGML_DISPATCH_KIND(kind, return occupancy(qgemm_bf16_kernel<F>, gemm_bf16_smem_bytes<F>(), n))
}

// kind 0 (q4_0) or 1 (q8_0); x f32 [M, K], qs uint8/int8 [N, K/32 * BYTES], d
// fp16 [N, K/32] -> y f32 [M, N], all contiguous and x, qs 16-byte aligned,
// on `stream`; bf16 != 0 computes the bf16 form. For M > 4, n_split (1 <=
// n_split <= K/32) from ops/qmatmul.py qmatmul_plan; with n_split > 1, part
// is f32 scratch of n_split * M * N (16-byte aligned); the bf16 form takes xb,
// bf16 scratch of M * K (16-byte aligned) for its pre-pass. M <= 4 ignores
// n_split, part and xb.
ZGML_EXPORT int zgml_qmatmul(int kind, const float* x, const uint8_t* qs, const void* d,
                             float* y, float* part, void* xb, int M, int N, int K, int n_split,
                             int bf16, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 != 0) return ZGML_ERR_SHAPE;
  if (M > GEMV_MAX_M && (n_split < 1 || n_split > K / 32 || n_split > 65535 ||
                         (n_split > 1 && part == nullptr) || (M + BM - 1) / BM > 65535 ||
                         (bf16 && xb == nullptr)))
    return ZGML_ERR_SHAPE;
  const __half* dh = static_cast<const __half*>(d);
  __nv_bfloat16* xbh = static_cast<__nv_bfloat16*>(xb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ZGML_DISPATCH_KIND(kind, return launch<F>(x, qs, dh, y, part, xbh, M, N, K, n_split, bf16 != 0,
                                            st))
}
