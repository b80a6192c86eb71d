// Weight streaming for the batch-1 decode kernels K7 (layer_attn.cu) and K6
// (ffn.cu): one persistent block an SM, WARPS consumer warps and one
// producer warp. The producer copies the block's weight rows with 1D bulk
// copies (TMA, cp.async.bulk ... mbarrier::complete_tx) into a ring of
// shared-memory slots, each with a full and an empty mbarrier, from kernel
// entry on, through every phase in order and across the grid barriers,
// which only the consumers pass, held by a Gate (at most `ahead` stages past
// the last phase whose activations the consumers staged). The consumers norm (or quantize) the
// activations into shared memory while the first slots land, then dot each
// landed slot's rows (one warp an item of two rows) and release the slot.
//
// The phases' units, the ring and the activation area come from the Python
// plan (ops/decode_plan.py, whose Phase and host ints this header reads);
// the launchers check it against the kernel's own needs. The dots keep the
// arithmetic and the order of a warp-per-row GEMV (common.cuh rows_f32):
// lane l takes blocks l, l + 32, ... of a row, each block summed in F::elem
// order and scaled by its d with one fma, the lanes then summed by the xor
// butterfly of warp_sum; the int8 block dots (`__dp4a`) are exact. Levels become
// floats by the exponent trick (2^23 + n, less 2^23 + 8 or + 128: exact and
// off the slow int-to-float unit), and a Q4_0 int8 block dot takes the
// unsigned nibbles less 8 times the activation block's sum (the same integer).
// No float atomics: two launches give the same bits.
//
// The whole-stack megacalls K14 / K15 (stack_decode.cu) stream a layer's four
// weights through one ring for every layer, and K15 dots bf16 weights
// (dot_bf16).
#pragma once

#include <atomic>

#include "decode_split.cuh"

namespace ws {

constexpr int WARPS = 16;                    // consumer warps
constexpr int CONSUMERS = WARPS * 32;
constexpr int THREADS = CONSUMERS + 32;      // and the producer warp
constexpr int MAX_STAGES = 16;               // mbarrier pairs in the header
// header: full[MAX_STAGES] and empty[MAX_STAGES] mbarriers, x_bar, the
// gate's count, the megacalls' unit ranges, then WARPS reduction floats
// (ops/decode_plan.py HEADER_BYTES)
constexpr int HEADER_BYTES = 16 * MAX_STAGES + 128;
constexpr int XPAD = 36;                     // floats a staged f32 32-block: float4 reads of 8
                                             // consecutive blocks hit 32 distinct banks
constexpr int XQ_STRIDE = 12;                // words a staged int8 32-block (8 + 4 padding)
constexpr int XQ_BYTES = 4 * XQ_STRIDE + 8;  // and its scale and level sum
constexpr int PLAN_HEADER = 8, PHASE_INTS = 6;
constexpr int ITEM_ROWS = 2;                 // weight rows a warp dots at once (an item)

static_assert(HEADER_BYTES % 128 == 0, "the ring starts 128-byte aligned");

// The consumers' barrier (named barrier 1; the producer warp never joins it).
__device__ __forceinline__ void sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}
struct Sync {
  __device__ __forceinline__ static void sync() { ws::sync(); }
};

__device__ __forceinline__ void fence_acq_rel() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

// The consumers' grid barrier, on three words (coop.barrier_words from word
// 2): two arrival counts and an epoch. A launch counts its arrivals in
// words[e & 1], e the epoch thread 0 reads when the block starts, and finds
// that count at 0: an arrival is one release reduction (no round trip), and
// a block passes once the count reaches its target (acquire loads). Once
// every block has passed the launch's first barrier, and so has read e,
// block 0 sets the epoch to e + 1 and zeroes the other count, which the
// launch before used (launches on one stream run one after another): the
// next launch finds its count at 0, and no block waits on an atomic as it
// leaves. The consumers' writes before a barrier are seen by every block
// after it (read back with __ldcg).
struct CountBarrier {
  unsigned int* words;
  unsigned int epoch;    // thread 0: the launch's epoch
  unsigned int target;   // thread 0: the count that ends the next barrier

  __device__ __forceinline__ void start(unsigned int* w) {
    words = w;
    target = 0;
    if (threadIdx.x == 0)                  // its latency overlaps the first phase
      asm volatile("ld.relaxed.gpu.u32 %0, [%1];\n" : "=r"(epoch) : "l"(w + 2) : "memory");
  }

  __device__ __forceinline__ void wait() {
    sync();
    if (threadIdx.x == 0) {
      unsigned int* count = words + (epoch & 1);
      target += gridDim.x;
      asm volatile("red.release.gpu.add.u32 [%0], 1;\n" ::"l"(count) : "memory");
      for (;;) {
        unsigned int c;
        asm volatile("ld.acquire.gpu.u32 %0, [%1];\n" : "=r"(c) : "l"(count) : "memory");
        if ((int)(c - target) >= 0) break;
        __nanosleep(32);
      }
      if (blockIdx.x == 0 && target == gridDim.x) {   // past the first barrier
        asm volatile("st.relaxed.gpu.u32 [%0], 0;\n" ::"l"(words + ((epoch + 1) & 1))
                     : "memory");
        asm volatile("st.relaxed.gpu.u32 [%0], %1;\n" ::"l"(words + 2), "r"(epoch + 1)
                     : "memory");
      }
    }
    sync();
  }
};

// ---- mbarriers and bulk copies (sm_90) --------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// wait until the phase of parity `parity` of *bar has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}
// `bytes` (a multiple of 16) from src to dst (both 16-byte aligned), counted on *bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- the plan -----------------------------------------------------------------

// One streamed weight (ops/decode_plan.py Phase): rows of k values; unit u
// is unit_rows rows from row (u / group_units) * group_rows + (u %
// group_units) * unit_rows, and with segs 2 the same rows + seg_off; block b
// takes units [bounds[b], bounds[b + 1]).
struct Phase {
  const uint8_t* qs;
  const __half* d;
  const int* bounds;
  int k, segs, seg_off, unit_rows, group_units, group_rows, unit_max;
};

// ahead: stages the producer may copy past the last phase whose
// activations the consumers staged (Gate): loads, atomics and polls an SM
// issues queue behind the copies it has in flight.
struct Ring {
  int stages, slot_bytes, act_off, ahead;
};

// A launch's streaming arguments: its N phases, its ring, and (K7) words of
// a zeroed workspace it leaves zeroed. K6 and K7 stream two weights; K7 with
// its phase E four.
template <int N>
struct ArgsN {
  Phase ph[N];
  Ring ring;
  unsigned int* counters;
};
using Args = ArgsN<2>;

// Phase i of a launcher's host plan ints (PLAN_HEADER ints, then PHASE_INTS a phase).
inline Phase plan_phase(const int* plan, int i, const uint8_t* qs, const void* d,
                        const int* bounds, int k) {
  const int* ph = plan + PLAN_HEADER + i * PHASE_INTS;
  return Phase{qs, static_cast<const __half*>(d), bounds + i * (plan[0] + 1), k, ph[0], ph[1],
               ph[2], ph[3], ph[4], ph[5]};
}

// Whether the plan's stages hold what its phases copy, every copy 16-byte
// aligned, and its area holds `act` bytes of activations.
template <class F>
inline bool plan_fits(const int* plan, const Phase* ph, int n, size_t act) {
  const int stages = plan[1], slot = plan[2];
  if (plan[0] < 1 || stages < 1 || stages > MAX_STAGES || slot % 128 != 0 ||
      (size_t)plan[3] < act || plan[4] != HEADER_BYTES + stages * slot + plan[3])
    return false;
  for (int i = 0; i < n; ++i) {
    const Phase& p = ph[i];
    const size_t rows = (size_t)p.unit_max * p.unit_rows;
    if (p.segs < 1 || p.segs > 2 || p.unit_rows < 1 || p.unit_max < 1 || p.group_units < 1 ||
        (size_t)p.unit_rows * p.k / 16 % 16 != 0 || p.segs * p.unit_rows % ITEM_ROWS != 0 ||
        p.segs * rows * (p.k / 32 * F::BYTES + p.k / 16) > (size_t)slot)
      return false;
  }
  return true;
}

__device__ __forceinline__ int stage_units(const Phase& ph, int u, int u1) {
  return min(min(u1 - u, ph.unit_max), ph.group_units - u % ph.group_units);
}
__device__ __forceinline__ int unit_row(const Phase& ph, int u) {
  return (u / ph.group_units) * ph.group_rows + (u % ph.group_units) * ph.unit_rows;
}

// The stages of units [u0, u1) of `ph` (stage_units' cut), a group at a
// time.
__device__ __forceinline__ int stage_count(const Phase& ph, int u0, int u1) {
  int c = 0;
  for (int u = u0; u < u1;) {
    const int end = min(u1, (u / ph.group_units + 1) * ph.group_units);
    c += (end - u + ph.unit_max - 1) / ph.unit_max;
    u = end;
  }
  return c;
}

__device__ __forceinline__ uint64_t* full_bar(uint8_t* smem, int s) {
  return reinterpret_cast<uint64_t*>(smem) + s;
}
__device__ __forceinline__ uint64_t* empty_bar(uint8_t* smem, int s) {
  return reinterpret_cast<uint64_t*>(smem) + MAX_STAGES + s;
}
__device__ __forceinline__ uint64_t* x_bar(uint8_t* smem) {
  return reinterpret_cast<uint64_t*>(smem) + 2 * MAX_STAGES;
}
// the count of released phases (Gate), written by consumer thread 0
__device__ __forceinline__ volatile unsigned* go_count(uint8_t* smem) {
  return reinterpret_cast<volatile unsigned*>(smem + 16 * MAX_STAGES + 16);
}
// the megacalls' unit ranges of this block, [u0, u1) per phase kind (at most 4)
__device__ __forceinline__ int* ranges(uint8_t* smem) {
  return reinterpret_cast<int*>(smem + 16 * MAX_STAGES + 32);
}
__device__ __forceinline__ float* red_area(uint8_t* smem) {
  return reinterpret_cast<float*>(smem + 16 * MAX_STAGES + 64);
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// All threads: thread 0 sets up the ring's barriers (full: the producer's
// one arrival and its bytes; empty: one arrival a consumer warp) and the
// gate's count (1: the first phase needs no staging).
__device__ __forceinline__ void ring_init(uint8_t* smem, const Ring& r) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < r.stages; ++s) {
      mbar_init(full_bar(smem, s), 1);
      mbar_init(empty_bar(smem, s), WARPS);
    }
    mbar_init(x_bar(smem), 1);
    *go_count(smem) = 1;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer's gate. `go` counts the phases whose activations the
// consumers have staged (1 at entry: the first phase needs none; release);
// phase j of the launch is phase kind j % KINDS of round j / KINDS (a layer
// of the megacalls, a row group of K6, K7's one), and this block runs cnt[k]
// stages of kind k a round. Stage n of the stream may be copied once n <
// end(g - 1) + ahead, g the count, end(j) the stages of phases 0 .. j: at
// most `ahead` stages are in flight past the last phase the consumers
// staged, whatever the phases' lengths (loads, atomics and polls an SM
// issues queue behind its bulk copies in flight).
template <int KINDS>
struct Gate {
  int cnt[KINDS];
  int ahead, seen, limit;

  // the block's unit range of kind k is [range[2k], range[2k + 1])
  __device__ __forceinline__ void start(const Phase* ph, const int* range, int ahead_) {
#pragma unroll
    for (int k = 0; k < KINDS; ++k) cnt[k] = stage_count(ph[k], range[2 * k], range[2 * k + 1]);
    ahead = ahead_;
    seen = 1;
    limit = end(0) + ahead;
  }
  __device__ __forceinline__ int end(int j) const {
    const int k = j % KINDS;
    int round = 0, part = 0;
#pragma unroll
    for (int i = 0; i < KINDS; ++i) {    // constant indices: cnt stays in registers
      round += cnt[i];
      if (i <= k) part += cnt[i];
    }
    return (j / KINDS) * round + part;
  }
  __device__ __forceinline__ void wait(const volatile unsigned* go, int n) {
    while (n >= limit) {
      const int g = (int)*go;
      if (g != seen) {
        seen = g;
        limit = end(g - 1) + ahead;
      } else {
        __nanosleep(64);
      }
    }
  }
};

// The consumers (all of them) release phases 0 .. j, as a rule once they
// have staged phase j's activations: the producer may run `ahead` stages
// past phase j (K6 releases the next row group's gate|up with w_down).
__device__ __forceinline__ void release(uint8_t* smem, int j) {
  sync();
  if (threadIdx.x == 0) *go_count(smem) = (unsigned)j + 1;
}

// The producer (one thread): copy the stages of units [u0, u1) of `ph`,
// stage n of the launch into slot n % stages, each once the gate lets it
// (gated false: the launch's first phase, which waits for no staging; the
// producer starts the gate after it, so counting its stages delays no
// copy). The gate passes by reference: through a pointer it would live in
// local memory.
template <class F, int KINDS>
__device__ __forceinline__ void produce(uint8_t* smem, const Ring& r, const Phase& ph, int u0,
                                        int u1, int& n, Gate<KINDS>& gate, bool gated) {
  const size_t rq = (size_t)ph.k / 32 * F::BYTES, rd = (size_t)ph.k / 16;
  const volatile unsigned* go = go_count(smem);
  for (int u = u0; u < u1;) {
    if (gated) gate.wait(go, n);
    const int c = stage_units(ph, u, u1), row = unit_row(ph, u), rows = c * ph.unit_rows;
    const int slot = n % r.stages;
    mbar_wait(empty_bar(smem, slot), ((n / r.stages) & 1) ^ 1);
    const uint32_t qb = (uint32_t)(rows * rq), db = (uint32_t)(rows * rd);
    uint8_t* dst = smem + HEADER_BYTES + (size_t)slot * r.slot_bytes;
    mbar_expect_tx(full_bar(smem, slot), ph.segs * (qb + db));
    for (int s = 0; s < ph.segs; ++s) {
      const size_t at = (size_t)row + (size_t)s * ph.seg_off;
      bulk_copy(dst + s * qb, ph.qs + at * rq, qb, full_bar(smem, slot));
      bulk_copy(dst + ph.segs * qb + s * db, reinterpret_cast<const uint8_t*>(ph.d) + at * rd,
                db, full_bar(smem, slot));
    }
    ++n;
    u += c;
  }
}

// This block's unit ranges of the launch's phases, [u0, u1) for each, from
// the plan's bounds.
template <int KINDS>
__device__ __forceinline__ void block_ranges(const Phase* ph, int* range) {
#pragma unroll
  for (int k = 0; k < KINDS; ++k) {
    range[2 * k] = __ldg(ph[k].bounds + blockIdx.x);
    range[2 * k + 1] = __ldg(ph[k].bounds + blockIdx.x + 1);
  }
}

// The producer's first copies, ahead of every weight byte: a_bytes from a
// and b_bytes from b (the rows to norm and their gain, multiples of 16
// bytes from 16-byte aligned addresses) into dst, counted on the
// activations' mbarrier. A load the consumers issued instead would queue
// behind the ring's copies.
__device__ __forceinline__ void produce_x(uint8_t* smem, float* dst, const float* a,
                                          uint32_t a_bytes, const float* b, uint32_t b_bytes) {
  mbar_expect_tx(x_bar(smem), a_bytes + b_bytes);
  bulk_copy(dst, a, a_bytes, x_bar(smem));
  bulk_copy(reinterpret_cast<uint8_t*>(dst) + a_bytes, b, b_bytes, x_bar(smem));
}

// The producer's end: wait until the consumers released every slot it
// filled, so no copy is in flight when it leaves.
__device__ __forceinline__ void produce_tail(uint8_t* smem, const Ring& r, int n) {
  for (int m = n - r.stages < 0 ? 0 : n - r.stages; m < n; ++m)
    mbar_wait(empty_bar(smem, m % r.stages), (m / r.stages) & 1);
}

// One landed stage as the consumers see it: `rows` rows a segment, laid out
// [seg 0 qs][seg 1 qs][seg 0 scales][seg 1 scales]; row j counts through
// the segments (j = s * rows + i).
template <class F>
struct StageView {
  const uint8_t* base;
  int rows, segs, nblk;
  __device__ __forceinline__ const uint8_t* qs(int j) const {
    return base + (size_t)j * nblk * F::BYTES;
  }
  __device__ __forceinline__ const __half* d(int j) const {
    return reinterpret_cast<const __half*>(base + (size_t)segs * rows * nblk * F::BYTES) +
           (size_t)j * nblk;
  }
};

// The consumers: for each stage of units [u0, u1) of `ph`, wait for it to
// land, run item(view, i, row) for the stage's items of R rows (i: the item
// in the stage, row: the stage's first row), dealt round robin over the
// warps by their index in the phase, and release the slot.
template <class F, int R, class Item>
__device__ __forceinline__ void consume_range(uint8_t* smem, const Ring& r, const Phase& ph,
                                              int u0, int u1, int& n, Item&& item) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int t0 = 0;
  for (int u = u0; u < u1;) {
    const int c = stage_units(ph, u, u1), rows = c * ph.unit_rows;
    const int slot = n % r.stages;
    const int items = ph.segs * rows / R;
    mbar_wait(full_bar(smem, slot), (n / r.stages) & 1);
    const StageView<F> v{smem + HEADER_BYTES + (size_t)slot * r.slot_bytes, rows, ph.segs,
                         ph.k / 32};
    for (int t = t0 + ((warp - t0) % WARPS + WARPS) % WARPS; t < t0 + items; t += WARPS)
      item(v, t - t0, unit_row(ph, u));
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar(smem, slot));
    t0 += items;
    ++n;
    u += c;
  }
}

// The same over this block's range of `ph`.
template <class F, int R, class Item>
__device__ __forceinline__ void consume(uint8_t* smem, const Ring& r, const Phase& ph, int& n,
                                        Item&& item) {
  consume_range<F, R>(smem, r, ph, __ldg(ph.bounds + blockIdx.x),
                      __ldg(ph.bounds + blockIdx.x + 1), n, item);
}

// ---- activations ---------------------------------------------------------------

// Sum of v over the consumers (all of them call it; red holds >= 32 floats),
// in block_sum's order.
__device__ __forceinline__ float consumer_sum(float v, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = warp_sum(v);
  sync();
  if (lane == 0) red[warp] = v;
  sync();
  float t = 0.f;
  for (int w = 0; w < WARPS; ++w) t += red[w];
  return t;
}

// 1 / rms of x over d values, summed by the consumers (thread i takes x[i],
// x[i + CONSUMERS], ...; then consumer_sum); x in shared or global memory
// (not written in the launch).
__device__ __forceinline__ float consumer_rms_inv(const float* x, int d, float eps, float* red) {
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += CONSUMERS) {
    const float v = x[i];
    ss = fmaf(v, v, ss);
  }
  return 1.0f / sqrtf(consumer_sum(ss, red) / (float)d + eps);
}

// bf16_rn(v) as a float: K15's rounding of an operand row
// (zgml_tpu/ops/tapekernel.py, `.astype(bf16)`).
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// dst[b * XPAD + j] = x[32 b + j] * inv * g[32 b + j], with BF16 (K15)
// rounded to bf16.
template <bool BF16 = false>
__device__ __forceinline__ void stage_norm(const float* x, const float* g, int d, float eps,
                                           float* dst, float* red) {
  const float inv = consumer_rms_inv(x, d, eps, red);
  for (int i = threadIdx.x; i < d; i += CONSUMERS) {
    const float v = x[i] * inv * g[i];
    dst[(i >> 5) * XPAD + (i & 31)] = BF16 ? round_bf16(v) : v;
  }
}

// dst[b * XPAD + j] = src[32 b + j], read with __ldcg (written in this launch),
// with BF16 rounded to bf16.
template <bool BF16 = false>
__device__ __forceinline__ void stage_rows(const float* src, int n, float* dst) {
  for (int i = threadIdx.x; i < n; i += CONSUMERS) {
    const float v = __ldcg(src + i);
    dst[(i >> 5) * XPAD + (i & 31)] = BF16 ? round_bf16(v) : v;
  }
}

// dst[i] = src[i] for n floats (n % 4 == 0, both 16-byte aligned), read with
// __ldcg (written in this launch).
__device__ __forceinline__ void copy_row(const float* src, int n, float* dst) {
  for (int i = threadIdx.x; i < n / 4; i += CONSUMERS)
    reinterpret_cast<float4*>(dst)[i] = __ldcg(reinterpret_cast<const float4*>(src) + i);
}

// The int8 activations of a normed row, each 32-block quantized by
// quantize_lane as K1's pre-pass quantizes it (bit-equal to the JAX pre-pass
// on the same normed row), staged as [d/32][XQ_STRIDE] words, then
// [d/32] scales, then [d/32] level sums; block 0 also writes the row to
// xq_out / xs_out where those are not null.
__device__ __forceinline__ void stage_norm_i8(const float* x, const float* g, int d, float eps,
                                              int* xq, float* red, int8_t* xq_out,
                                              float* xs_out) {
  const float inv = consumer_rms_inv(x, d, eps, red);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nb = d / 32;
  int8_t* xq8 = reinterpret_cast<int8_t*>(xq);
  float* xsc = reinterpret_cast<float*>(xq + nb * XQ_STRIDE);
  int* xsum = xq + nb * (XQ_STRIDE + 1);
  for (int b = warp; b < nb; b += WARPS) {
    const int i = b * 32 + lane;
    float s;
    const int q = quantize_lane(x[i] * inv * g[i], s);
    xq8[b * XQ_STRIDE * 4 + lane] = (int8_t)q;
    const int sum = __reduce_add_sync(0xFFFFFFFFu, q);
    if (lane == 0) {
      xsc[b] = s;
      xsum[b] = sum;
    }
    if (xq_out != nullptr && blockIdx.x == 0) {
      xq_out[i] = (int8_t)q;
      if (lane == 0) xs_out[b] = s;
    }
  }
}

// Zero rows (a group's rows past M): n floats staged, or an int8 row's words.
__device__ __forceinline__ void zero_words(uint32_t* dst, int n) {
  for (int i = threadIdx.x; i < n; i += CONSUMERS) dst[i] = 0u;
}

// ---- the dots ------------------------------------------------------------------

// Level n of a 4-bit nibble or biased byte held in byte k of v, as a float:
// 2^23 + n from the bits, less the exponent and the bias (exact).
template <int K>
__device__ __forceinline__ float byte_float(uint32_t v) {
  return __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7540u | K));
}

// The 8 levels of a Q4_0 word in the order a block's sum takes them:
// elements 4q + k (byte k's low nibble) and 16 + 4q + k (its high one).
__device__ __forceinline__ void levels_q4(uint32_t w, float (&l)[8]) {
  const uint32_t lo = w & 0x0F0F0F0Fu, hi = (w >> 4) & 0x0F0F0F0Fu;
  l[0] = byte_float<0>(lo) - 8388616.f;
  l[1] = byte_float<0>(hi) - 8388616.f;
  l[2] = byte_float<1>(lo) - 8388616.f;
  l[3] = byte_float<1>(hi) - 8388616.f;
  l[4] = byte_float<2>(lo) - 8388616.f;
  l[5] = byte_float<2>(hi) - 8388616.f;
  l[6] = byte_float<3>(lo) - 8388616.f;
  l[7] = byte_float<3>(hi) - 8388616.f;
}

// The 4 levels of a Q8_0 word (signed bytes, biased by 128 into the bits).
__device__ __forceinline__ void levels_q8(uint32_t w, float (&l)[4]) {
  const uint32_t u = w ^ 0x80808080u;
  l[0] = byte_float<0>(u) - 8388736.f;
  l[1] = byte_float<1>(u) - 8388736.f;
  l[2] = byte_float<2>(u) - 8388736.f;
  l[3] = byte_float<3>(u) - 8388736.f;
}

template <class F>
__device__ __forceinline__ void smem_block(const uint8_t* row, int b, uint32_t (&w)[F::WORDS]) {
  const uint4* p = reinterpret_cast<const uint4*>(row) + (size_t)b * (F::BYTES / 16);
#pragma unroll
  for (int i = 0; i < F::BYTES / 16; ++i) {
    const uint4 v = p[i];
    w[4 * i] = v.x;
    w[4 * i + 1] = v.y;
    w[4 * i + 2] = v.z;
    w[4 * i + 3] = v.w;
  }
}

// Rows j[0..R) of a landed stage (an item) against MR staged f32 rows (row
// m at xs + m * stride, [nblk][XPAD]): each lane's partial per row
// (rows_f32's order; the caller reduces over the warp). The activations are
// loaded once for all R rows.
template <class F, int R, int MR>
__device__ __forceinline__ void dot_f32(const StageView<F>& v, const int (&j)[R], const float* xs,
                                        int stride, int lane, float (&acc)[R][MR]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < MR; ++m) acc[r][m] = 0.f;
  for (int b = lane; b < v.nblk; b += 32) {
    uint32_t w[R][F::WORDS];
    float sc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      smem_block<F>(v.qs(j[r]), b, w[r]);
      sc[r] = __half2float(v.d(j[r])[b]);
    }
    const float* xb = xs + b * XPAD;
    float sum[R][MR];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int m = 0; m < MR; ++m) sum[r][m] = 0.f;
    if constexpr (F::KIND == 0) {   // Q4_0: elements 4q+k (low nibble), 16+4q+k (high)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float l[R][8];
#pragma unroll
        for (int r = 0; r < R; ++r) levels_q4(w[r][q], l[r]);
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          const float4 a = *reinterpret_cast<const float4*>(xb + m * stride + 4 * q);
          const float4 c = *reinterpret_cast<const float4*>(xb + m * stride + 16 + 4 * q);
          const float x8[8] = {a.x, c.x, a.y, c.y, a.z, c.z, a.w, c.w};
#pragma unroll
          for (int t = 0; t < 8; ++t)
#pragma unroll
            for (int r = 0; r < R; ++r) sum[r][m] = fmaf(l[r][t], x8[t], sum[r][m]);
        }
      }
    } else {                        // Q8_0: elements in order
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        float l[R][4];
#pragma unroll
        for (int r = 0; r < R; ++r) levels_q8(w[r][q], l[r]);
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          const float4 a = *reinterpret_cast<const float4*>(xb + m * stride + 4 * q);
          const float x4[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
          for (int t = 0; t < 4; ++t)
#pragma unroll
            for (int r = 0; r < R; ++r) sum[r][m] = fmaf(l[r][t], x4[t], sum[r][m]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int m = 0; m < MR; ++m) acc[r][m] = fmaf(sum[r][m], sc[r], acc[r][m]);
  }
}

// K15's dot: rows j[0..R) of a landed Q4_0 stage against one staged row of
// bf16-rounded floats (xs, [nblk][XPAD]), on the weights bf16_rn(level *
// bf16_rn(d)) (zgml_tpu/ops/tapekernel.py _deq_rows): a level pair becomes
// bf16x2 by the exponent trick (0x4300 | n is 128 + n, exact), less 136
// (exact), times the bf16x2 scale (one rounding, so each weight is
// tapekernel.bf16_weight's bit for bit), then widened by a shift. Every
// product is exact in f32. Lane l takes blocks l, l + 32, ...; a block's 32
// products are summed from 0 by fma in pair order (word q = 0..3, then the
// nibble pairs at shifts 0, 4, 8, 12: elements 16h + 4q + k and 16h + 4q + k
// + 2 with k = shift / 8, h = shift / 4 % 2), and added to the lane's sum
// (the caller reduces over the warp).
template <int R>
__device__ __forceinline__ void dot_bf16(const StageView<FmtQ4_0>& v, const int (&j)[R],
                                         const float* xs, int lane, float (&acc)[R]) {
  const __nv_bfloat162 bias = __floats2bfloat162_rn(136.f, 136.f);
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  for (int b = lane; b < v.nblk; b += 32) {
    uint32_t w[R][4];
    __nv_bfloat162 sc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      smem_block<FmtQ4_0>(v.qs(j[r]), b, w[r]);
      sc[r] = __bfloat162bfloat162(__float2bfloat16_rn(__half2float(v.d(j[r])[b])));
    }
    const float* xb = xs + b * XPAD;
    float sum[R];
#pragma unroll
    for (int r = 0; r < R; ++r) sum[r] = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 a = *reinterpret_cast<const float4*>(xb + 4 * q);
      const float4 c = *reinterpret_cast<const float4*>(xb + 16 + 4 * q);
      const float x8[8] = {a.x, a.z, c.x, c.z, a.y, a.w, c.y, c.w};
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const uint32_t lv = ((w[r][q] >> (4 * s)) & 0x000F000Fu) | 0x43004300u;
          const __nv_bfloat162 wv =
              __hmul2(__hsub2(*reinterpret_cast<const __nv_bfloat162*>(&lv), bias), sc[r]);
          const uint32_t u = *reinterpret_cast<const uint32_t*>(&wv);
          sum[r] = fmaf(__uint_as_float(u << 16), x8[2 * s], sum[r]);
          sum[r] = fmaf(__uint_as_float(u & 0xFFFF0000u), x8[2 * s + 1], sum[r]);
        }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] += sum[r];
  }
}

// The same on MR staged int8 rows (row m's words at xq + m * xq_row, laid
// out as stage_norm_i8 stages them): exact block dots, then acc +=
// float(isum) * (xs * d), in dot_f32's order.
template <class F, int R, int MR>
__device__ __forceinline__ void dot_i8(const StageView<F>& v, const int (&j)[R], const int* xq,
                                       int xq_row, int lane, float (&acc)[R][MR]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < MR; ++m) acc[r][m] = 0.f;
  const int nb = v.nblk;
  const float* xsc = reinterpret_cast<const float*>(xq + nb * XQ_STRIDE);
  const int* xsum = xq + nb * (XQ_STRIDE + 1);
  for (int b = lane; b < nb; b += 32) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      uint32_t w[F::WORDS];
      smem_block<F>(v.qs(j[r]), b, w);
      const float sw = __half2float(v.d(j[r])[b]);
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        const int* xb = xq + m * xq_row + b * XQ_STRIDE;
        const int4 xa = *reinterpret_cast<const int4*>(xb);
        const int4 xc = *reinterpret_cast<const int4*>(xb + 4);
        const int x8[8] = {xa.x, xa.y, xa.z, xa.w, xc.x, xc.y, xc.z, xc.w};
        int isum;
        if constexpr (F::KIND == 0) {   // sum (n - 8) x = sum n x - 8 sum x
          isum = -8 * xsum[m * xq_row + b];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            isum = __dp4a((int)(w[q] & 0x0F0F0F0Fu), x8[q], isum);
            isum = __dp4a((int)((w[q] >> 4) & 0x0F0F0F0Fu), x8[4 + q], isum);
          }
        } else {
          isum = 0;
#pragma unroll
          for (int q = 0; q < 8; ++q) isum = __dp4a((int)w[q], x8[q], isum);
        }
        acc[r][m] = fmaf((float)isum, __fmul_rn(xsc[m * xq_row + b], sw), acc[r][m]);
      }
    }
  }
}

// The stage rows of item i of R rows: with two segments R/2 units' rows of
// each (segment 0, segment 1, alternating), with one R consecutive rows;
// j[r] counts through the stage's segments, out[r] is the row's index in
// its segment's weight rows less the stage's first row.
template <int R, class F>
__device__ __forceinline__ void item_rows(const StageView<F>& v, int i, int (&j)[R],
                                          int (&out)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (v.segs == 2) {
      out[r] = i * (R / 2) + r / 2;
      j[r] = (r & 1) * v.rows + out[r];
    } else {
      out[r] = i * R + r;
      j[r] = out[r];
    }
  }
}

// 32-bit words of one staged int8 row of d values (its levels, scales and
// sums), rounded up to 16 bytes: the stride of K6c's rows.
__host__ __device__ constexpr int xq_words(int d) { return (d / 32 * XQ_BYTES / 4 + 3) & ~3; }

// Set the launch's shared-memory ceiling once per kernel and card (an
// attribute set, not a query), then launch it cooperatively: the plan's grid
// is one block an SM, all resident, so the consumers' grid barriers cannot
// wait on a block that is not running.
template <typename P, typename A>
inline int launch(void (*kernel)(P, A), const P& p, const A& a, int grid, int smem, int device,
                  std::atomic<unsigned>& ready, cudaStream_t st) {
  if (device < 0 || device >= 32) return ZGML_ERR_SHAPE;
  if (!(ready.load() & (1u << device))) {
    const int rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (rc != 0) return rc;
    ready.fetch_or(1u << device);
  }
  P pc = p;
  A ac = a;
  void* args[] = {&pc, &ac};
  const int rc = (int)cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(THREADS),
                                                  args, (size_t)smem, st);
  return rc != 0 ? rc : (int)cudaGetLastError();
}

}  // namespace ws
