// K2 qmatmul: y[M, N] = x[M, K] @ dequant(W)^T, W in Q4_0 (K2q4) or Q8_0
// (K2q8), f32 in and out.
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

template <class F>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
qgemv_kernel(const float* __restrict__ x, const uint8_t* __restrict__ qs,
             const __half* __restrict__ d, float* __restrict__ y, int N, int K) {
  extern __shared__ float xs[];   // [K/32][33]
  const int m = blockIdx.y;
  const int nblk = K / 32;
  const float* xm = x + (size_t)m * K;
  for (int i = threadIdx.x; i < K; i += blockDim.x) xs[(i >> 5) * 33 + (i & 31)] = xm[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * GEMV_WARPS + warp;
  if (n >= N) return;
  const uint8_t* row[1] = {qs + (size_t)n * nblk * F::BYTES};
  const __half* drow[1] = {d + (size_t)n * nblk};
  float acc[1];
  rows_f32<F, 1>(row, drow, xs, nblk, lane, acc);
  const float s = warp_sum(acc[0]);
  if (lane == 0) y[(size_t)m * N + n] = s;
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
  // acc[4j + e]: row xr (+8 for e >= 2), column 8j + 2 tig (+1 for odd e)
  float* out = p.out + (size_t)blockIdx.z * p.M * p.N;
  const bool pairs = (p.N & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + xr + 8 * h;
    if (m >= p.M) continue;
    float* yr = out + (size_t)m * p.N;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + 8 * j + 2 * tig;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (pairs && n + 1 < p.N) {
        *reinterpret_cast<float2*>(yr + n) = make_float2(v0, v1);
      } else {
        if (n < p.N) yr[n] = v0;
        if (n + 1 < p.N) yr[n + 1] = v1;
      }
    }
  }
}

template <class F>
int launch(const float* x, const uint8_t* qs, const __half* d, float* y, float* part, int M,
           int N, int K, int n_split, cudaStream_t st) {
  if (M <= GEMV_MAX_M) {
    const size_t smem = (size_t)(K / 32) * 33 * sizeof(float);
    const int rc = allow_dynamic_smem(qgemv_kernel<F>, smem);
    if (rc != 0) return rc;
    const dim3 grid((N + GEMV_WARPS - 1) / GEMV_WARPS, M);
    qgemv_kernel<F><<<grid, GEMV_WARPS * 32, smem, st>>>(x, qs, d, y, N, K);
    return (int)cudaGetLastError();
  }
  constexpr size_t smem = gemm_smem_bytes<F>();
  int rc = allow_dynamic_smem(qgemm_tf32_kernel<F>, smem);
  if (rc != 0) return rc;
  const GemmParams p{x, qs, d, n_split > 1 ? part : y, M, N, K, n_split};
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, n_split);
  qgemm_tf32_kernel<F><<<grid, THREADS, smem, st>>>(p);
  rc = (int)cudaGetLastError();
  if (rc != 0 || n_split == 1) return rc;
  return tf32::sum_parts(part, y, (long long)M * N, n_split, st);
}

}  // namespace

// *n = the blocks of the kind's tiled K2 kernel one SM holds at once (the
// occupancy ops/qmatmul.py qmatmul_plan fills); returns a status.
ZGML_EXPORT int zgml_qmatmul_blocks_per_sm(int kind, int* n) {
  ZGML_DISPATCH_KIND(kind, {
    constexpr size_t smem = gemm_smem_bytes<F>();
    const int rc = allow_dynamic_smem(qgemm_tf32_kernel<F>, smem);
    if (rc != 0) return rc;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, qgemm_tf32_kernel<F>, THREADS,
                                                              smem);
  })
}

// kind 0 (q4_0) or 1 (q8_0); x f32 [M, K], qs uint8/int8 [N, K/32 * BYTES], d
// fp16 [N, K/32] -> y f32 [M, N], all contiguous and x, qs 16-byte aligned,
// on `stream`. For M > 4, n_split (1 <= n_split <= K/32) from ops/qmatmul.py
// qmatmul_plan; with n_split > 1, part is f32 scratch of n_split * M * N
// (16-byte aligned). M <= 4 ignores n_split and part.
ZGML_EXPORT int zgml_qmatmul(int kind, const float* x, const uint8_t* qs, const void* d,
                             float* y, float* part, int M, int N, int K, int n_split,
                             void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 != 0) return ZGML_ERR_SHAPE;
  if (M > GEMV_MAX_M && (n_split < 1 || n_split > K / 32 || n_split > 65535 ||
                         (n_split > 1 && part == nullptr) || (M + BM - 1) / BM > 65535))
    return ZGML_ERR_SHAPE;
  const __half* dh = static_cast<const __half*>(d);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ZGML_DISPATCH_KIND(kind, return launch<F>(x, qs, dh, y, part, M, N, K, n_split, st))
}
