// K4 decode_attention: one query token per row, GQA, over the bf16 KV cache;
// and its int8-cache mode, K8 decode_attention_q8.
//
// Replaces: zgml_tpu/ops/attention.py `_decode_kernel` (line 282), reached
// through `_decode` / `decode_attention_pallas` (K4), and `_decode_q8_kernel`
// (line 395, pallas_call at 506), reached through `_decode_q8` /
// `decode_attention_q8_pallas` (K8; its ZGML_TPU_ATTN_I8PV mode, p quantized
// per block, is not ported and the wrapper's caller refuses it).
//
// K4's semantics (the plain version is ops/attention.py decode_attention_ref):
//   q f32 [B, Hq, 1, D]; k, v bf16 [R, Hkv, S, D] read in place at batch rows
//   kv_row + b; row b attends keys j < kv_len[b] (int32 on the device, so a
//   decode step needs no host sync). Output f32 [B, Hq, 1, D]; a row with
//   kv_len 0 gives 0.
//
// What bounds it on the H100: HBM bytes, 2 * kv_len * D * 2 per KV head per
// row for ~4 flops per byte (2.1 MB, 0.6 us, at TinyLlama-1.1B's 4 heads and
// 2047 keys); but at decode sizes its time is latency: a launch, a round
// trip for the keys, one for the merge.
//
// What K4's design does about it (decode_bf16_kernel, one launch): the grid
// is (n_split, B * Hkv), n_split from the SM count and B * Hkv alone
// (ops/decode_plan.py decode_splits), so no host sync and no dependence on
// S beyond a cap. Each block reads kv_len[b] on the device and takes its own
// balanced share of the row's 32-key groups (decode_split_keys): none reads
// past kv_len, and at short lengths the blocks without keys leave at once.
// A warp takes one group at a time, its K and V tiles copied to shared
// memory by cp.async (the next one in flight): each lane scores one key
// against the group's query heads (q in shared memory, read as broadcasts),
// the warp runs online softmax over the 32 scores, and the lanes, each owning
// D/32 dimensions, accumulate p V for every head, so no chain runs longer
// than D or 32; a block with fewer groups than warps splits each group's
// heads over several warps. The warps merge in shared memory in warp order; a block writes its
// partial (unnormalised o, max, sum) per query head, and the last block of a
// (row, KV head) to take a ticket on its counter word (ops/coop.counter_words)
// merges the splits in split order, so two launches give the same bits, and
// leaves the word at zero. A row whose keys one block holds writes o itself.
//
// K8 (the plain version is ops/attention.py decode_attention_q8_ref) keeps
// the split-KV design of the first port: k, v are the position-major int8
// cache [R, Hkv, S, D] with f32 scales ks, vs [R, Hkv, S]; the grid is (S/128
// chunks, B*Hkv), each block takes one KV head over one 128-key chunk and
// serves all n_rep query heads from one shared-memory copy of the chunk
// (decode_split.cuh, shared with K7's phase B: it quantizes the f32 q rows of
// its group per query head, scores are exact int8 dots times q_scale *
// k_scale * scale, and P.V runs in f32 on the levels with the V scales folded
// into p); blocks past kv_len exit at once; a second small kernel merges the
// chunks with the usual rescaling.
#include "decode_split.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int DA_THREADS = 128;

// ---- K4 ----------------------------------------------------------------------

constexpr int DK_WARPS = 4;              // ops/decode_plan.py DECODE_WARPS
constexpr int DK_THREADS = DK_WARPS * 32;
constexpr int DK_GROUP = 32;             // keys a warp scores at once, one a lane
constexpr int DK_RG = 8;                 // query heads a pass over the keys
constexpr int DK_MAX_SPLIT = 16;         // ops/decode_plan.py DECODE_MAX_SPLIT

// Dynamic shared memory of decode_bf16_kernel<D>: q [n_rep][D] f32; each
// warp's two K tiles [32][D + 8] (rows padded by 16 bytes: the lanes' row
// reads hit 32 banks) and two V tiles [32][D], bf16; p [DK_WARPS][DK_RG][32],
// the warps' max and sum [DK_WARPS][DK_RG] each and their o
// [DK_WARPS][DK_RG][D]; the merge flag.
template <int D>
__host__ __device__ constexpr int dk_krow() { return D + 8; }
template <int D>
size_t dk_smem_bytes(int n_rep) {
  return sizeof(float) * ((size_t)n_rep * D + DK_WARPS * DK_RG * (DK_GROUP + 2 + D) +
                          (size_t)n_rep * 2 * DK_MAX_SPLIT) +
         2 * (size_t)DK_WARPS * 2 * DK_GROUP * (dk_krow<D>() + D) + 16;
}

// dims this lane owns in P.V, from its first (lanes past D repeat lanes below)
template <int DPL>
__device__ __forceinline__ void load_v(const __nv_bfloat16* p, float (&vv)[DPL]) {
  if constexpr (DPL == 1) {
    vv[0] = __uint_as_float((uint32_t)*reinterpret_cast<const unsigned short*>(p) << 16);
  } else if constexpr (DPL == 2) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
    vv[0] = bf16_lo(u);
    vv[1] = bf16_hi(u);
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    vv[0] = bf16_lo(u.x);
    vv[1] = bf16_hi(u.x);
    vv[2] = bf16_lo(u.y);
    vv[3] = bf16_hi(u.y);
  }
}

// Whether split s of n holds any of a row's G groups (decode_split_keys).
__device__ __forceinline__ bool split_live(int s, int n, int G) {
  return (unsigned)((s + 1) * G) / n > (unsigned)(s * G) / n;    // G <= S / 32, n <= 16
}

// One warp's copies of group gi's K and V tiles (keys gi * 32 .. + 31 of the
// head, rows at or past len zero-filled and not read) into kt / vt.
template <int D>
__device__ __forceinline__ void copy_group(const __nv_bfloat16* kb, const __nv_bfloat16* vb,
                                           int gi, int len, __nv_bfloat16* kt,
                                           __nv_bfloat16* vt, int lane) {
  constexpr int CH = D / 8;                            // 16-byte chunks a row
  for (int i = lane; i < DK_GROUP * CH; i += 32) {
    const int r = i / CH, c = i % CH, j = gi * DK_GROUP + r;
    const bool live = j < len;
    const size_t at = (size_t)(live ? j : 0) * D + c * 8;
    tf32::cp_async16(kt + r * dk_krow<D>() + c * 8, kb + at, live);
    tf32::cp_async16(vt + r * D + c * 8, vb + at, live);
  }
}

template <int D>
__global__ void __launch_bounds__(DK_THREADS)
decode_bf16_kernel(const float* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const int* __restrict__ kv_len,
                   float* __restrict__ o, float* __restrict__ part, unsigned int* counters,
                   int Hq, int Hkv, int S, int kv_row, float scale, int n_split) {
  constexpr int DPL = D >= 32 ? D / 32 : 1;
  constexpr int KT = DK_GROUP * dk_krow<D>(), VT = DK_GROUP * D;    // bf16s a tile
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_rep = Hq / Hkv;
  const int bh = blockIdx.y, b = bh / Hkv, hk = bh % Hkv, split = blockIdx.x;
  const int h0 = b * Hq + hk * n_rep;                  // first query head of the group
  float* qs = smem;                                    // [n_rep][D]
  // q in flight while kv_len is read (a block without keys waits for it too)
  for (int i = threadIdx.x; i < n_rep * D / 4; i += DK_THREADS)
    tf32::cp_async16(qs + 4 * i, q + (size_t)h0 * D + 4 * i, true);
  tf32::cp_async_commit();
  const int len = min(max(__ldg(kv_len + b), 0), S);
  const int G = (len + DK_GROUP - 1) / DK_GROUP;
  const int g0 = (int)((unsigned)(split * G) / n_split);
  const int g1 = (int)((unsigned)((split + 1) * G) / n_split);
  if (g0 == g1) {                                      // no group here (kv_len 0: split 0 writes 0)
    if (G == 0 && split == 0)
      for (int i = threadIdx.x; i < n_rep * D; i += DK_THREADS) o[(size_t)h0 * D + i] = 0.f;
    tf32::cp_async_wait<0>();
    return;
  }
  const int live = min(n_split, G);                    // splits that hold groups
  float* ps = qs + n_rep * D;                          // [DK_WARPS][DK_RG][32]
  float* wm = ps + DK_WARPS * DK_RG * DK_GROUP;        // [DK_WARPS][DK_RG]
  float* wl = wm + DK_WARPS * DK_RG;
  float* wo = wl + DK_WARPS * DK_RG;                   // [DK_WARPS][DK_RG][D]
  __nv_bfloat16* kt = reinterpret_cast<__nv_bfloat16*>(wo + DK_WARPS * DK_RG * D) +
                      (size_t)warp * 2 * (KT + VT);    // this warp's tiles: K0 V0 K1 V1
  int* flag = reinterpret_cast<int*>(reinterpret_cast<__nv_bfloat16*>(wo + DK_WARPS * DK_RG * D) +
                                     (size_t)DK_WARPS * 2 * (KT + VT));
  const size_t pos0 = ((size_t)(kv_row + b) * Hkv + hk) * S;
  const __nv_bfloat16* kb = k + pos0 * D;
  const __nv_bfloat16* vb = v + pos0 * D;
  const int dl = (lane * DPL) % D;                     // this lane's first dim in P.V
  // a block with fewer groups than warps gives each group hs warps, which
  // split its query heads: warp w takes groups g0 + w / hs, + DK_WARPS / hs,
  // ..., and heads [ra, rb) of each pass
  const int hs = g1 - g0 >= DK_WARPS ? 1 : DK_WARPS / (g1 - g0);
  const int gf = g0 + warp / hs, step = DK_WARPS / hs;
  for (int r0 = 0; r0 < n_rep; r0 += DK_RG) {
    const int nr = min(DK_RG, n_rep - r0);
    const int per = (nr + hs - 1) / hs;
    const int ra = min(nr, (warp % hs) * per), rb = min(nr, ra + per);
    const int g_end = ra < rb ? g1 : gf;               // a warp without heads takes no group
    // this warp's first two groups in flight (with q, at r0 = 0)
    if (gf < g_end) copy_group<D>(kb, vb, gf, len, kt, kt + KT, lane);
    tf32::cp_async_commit();
    if (gf + step < g_end)
      copy_group<D>(kb, vb, gf + step, len, kt + KT + VT, kt + 2 * KT + VT, lane);
    tf32::cp_async_commit();
    tf32::cp_async_wait<1>();
    __syncthreads();                                   // q from every thread's copies
    float mr[DK_RG], lr[DK_RG], orr[DK_RG][DPL];
#pragma unroll
    for (int r = 0; r < DK_RG; ++r) {
      mr[r] = -INFINITY;
      lr[r] = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) orr[r][i] = 0.f;
    }
    int buf = 0;
    for (int gi = gf; gi < g_end; gi += step, buf ^= 1) {
      const __nv_bfloat16* kg = kt + buf * (KT + VT);
      const __nv_bfloat16* vg = kg + KT;
      const int j = gi * DK_GROUP + lane;
      const bool valid = j < len;
      float s[DK_RG];
#pragma unroll
      for (int r = 0; r < DK_RG; ++r) s[r] = 0.f;
      {                                                // lane j's key against the heads
        const uint4* kr = reinterpret_cast<const uint4*>(kg + lane * dk_krow<D>());
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          const uint4 u = kr[c];
          const float kf[8] = {bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y), bf16_hi(u.y),
                               bf16_lo(u.z), bf16_hi(u.z), bf16_lo(u.w), bf16_hi(u.w)};
#pragma unroll
          for (int r = 0; r < DK_RG; ++r)
            if (r >= ra && r < rb) {
              const float4 qa = *reinterpret_cast<const float4*>(qs + (r0 + r) * D + 8 * c);
              const float4 qb = *reinterpret_cast<const float4*>(qs + (r0 + r) * D + 8 * c + 4);
              s[r] = fmaf(qa.x, kf[0], s[r]);
              s[r] = fmaf(qa.y, kf[1], s[r]);
              s[r] = fmaf(qa.z, kf[2], s[r]);
              s[r] = fmaf(qa.w, kf[3], s[r]);
              s[r] = fmaf(qb.x, kf[4], s[r]);
              s[r] = fmaf(qb.y, kf[5], s[r]);
              s[r] = fmaf(qb.z, kf[6], s[r]);
              s[r] = fmaf(qb.w, kf[7], s[r]);
            }
        }
      }
      // online softmax over the group (key 0 of a group is always live)
#pragma unroll
      for (int r = 0; r < DK_RG; ++r)
        if (r >= ra && r < rb) {
          const float sr = valid ? s[r] * scale : -INFINITY;
          const float mn = fmaxf(mr[r], warp_max(sr));
          const float alpha = expf(mr[r] - mn);
          const float p = expf(sr - mn);
          lr[r] = fmaf(lr[r], alpha, p);
#pragma unroll
          for (int i = 0; i < DPL; ++i) orr[r][i] *= alpha;
          mr[r] = mn;
          ps[(warp * DK_RG + r) * DK_GROUP + lane] = p;
        }
      __syncwarp();
      const int nk = min(DK_GROUP, len - gi * DK_GROUP);
      for (int jj = 0; jj < nk; ++jj) {                // p V: lanes own dims
        float vv[DPL];
        load_v<DPL>(vg + jj * D + dl, vv);
#pragma unroll
        for (int r = 0; r < DK_RG; ++r)
          if (r >= ra && r < rb) {
            const float p = ps[(warp * DK_RG + r) * DK_GROUP + jj];
#pragma unroll
            for (int i = 0; i < DPL; ++i) orr[r][i] = fmaf(p, vv[i], orr[r][i]);
          }
      }
      __syncwarp();                                    // the tiles and p are read
      if (gi + 2 * step < g_end)                       // this buffer's next group
        copy_group<D>(kb, vb, gi + 2 * step, len, kt + buf * (KT + VT),
                      kt + buf * (KT + VT) + KT, lane);
      tf32::cp_async_commit();
      tf32::cp_async_wait<1>();
      __syncwarp();
    }
#pragma unroll
    for (int r = 0; r < DK_RG; ++r)                    // heads outside [ra, rb): sum 0
      if (r < nr) {
        const bool mine = r >= ra && r < rb;
        const float lsum = mine ? warp_sum(lr[r]) : 0.f;
        if (lane == 0) {
          wm[warp * DK_RG + r] = mr[r];
          wl[warp * DK_RG + r] = lsum;
        }
        if (mine && lane * DPL < D)
#pragma unroll
          for (int i = 0; i < DPL; ++i) wo[(warp * DK_RG + r) * D + dl + i] = orr[r][i];
      }
    __syncthreads();
    // the block's partial per query head: its warps merged in warp order
    for (int i = threadIdx.x; i < nr * D; i += DK_THREADS) {
      const int r = i / D, d = i % D;
      float mx = -INFINITY;
      for (int w = 0; w < DK_WARPS; ++w)
        if (wl[w * DK_RG + r] > 0.f) mx = fmaxf(mx, wm[w * DK_RG + r]);
      float num = 0.f, den = 0.f;
      for (int w = 0; w < DK_WARPS; ++w) {
        const float l = wl[w * DK_RG + r];
        if (l > 0.f) {
          const float e = expf(wm[w * DK_RG + r] - mx);
          num = fmaf(e, wo[(w * DK_RG + r) * D + d], num);
          den = fmaf(e, l, den);
        }
      }
      const size_t h = (size_t)h0 + r0 + r;
      if (live == 1) {
        o[h * D + d] = num / den;
      } else {
        float* pp = part + (h * n_split + split) * (D + 2);
        pp[d] = num;
        if (d == 0) {
          pp[D] = mx;
          pp[D + 1] = den;
        }
      }
    }
    __syncthreads();                                   // the areas serve the next heads
  }
  if (live == 1) return;
  // the last live split of (row, KV head) to arrive merges them in split order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool last = atomicAdd(counters + bh, 1u) == (unsigned)live - 1;
    if (last) counters[bh] = 0u;
    *flag = last;
  }
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  // the splits' max and sum per head into shared memory (all loads at once),
  // then each (head, dim) adds the live splits' o in split order
  float* sm = reinterpret_cast<float*>(flag) + 4;      // [n_rep][DK_MAX_SPLIT] max, then sums
  float* sl = sm + n_rep * DK_MAX_SPLIT;
  for (int i = threadIdx.x; i < n_rep * DK_MAX_SPLIT; i += DK_THREADS) {
    const int r = i / DK_MAX_SPLIT, sp = i % DK_MAX_SPLIT;
    const bool on = sp < n_split && split_live(sp, n_split, G);
    const float* pp = part + (((size_t)h0 + r) * n_split + sp) * (D + 2);
    sm[i] = on ? __ldcg(pp + D) : -INFINITY;
    sl[i] = on ? __ldcg(pp + D + 1) : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_rep * D; i += DK_THREADS) {
    const int r = i / D, d = i % D;
    const size_t h = (size_t)h0 + r;
    const float* ph = part + h * n_split * (D + 2) + d;
    float mx = -INFINITY;
#pragma unroll
    for (int sp = 0; sp < DK_MAX_SPLIT; ++sp) mx = fmaxf(mx, sm[r * DK_MAX_SPLIT + sp]);
    float ov[DK_MAX_SPLIT];
#pragma unroll
    for (int sp = 0; sp < DK_MAX_SPLIT; ++sp)
      ov[sp] = sl[r * DK_MAX_SPLIT + sp] > 0.f ? __ldcg(ph + sp * (D + 2)) : 0.f;
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int sp = 0; sp < DK_MAX_SPLIT; ++sp) {
      const float l = sl[r * DK_MAX_SPLIT + sp];
      if (l > 0.f) {
        const float e = expf(sm[r * DK_MAX_SPLIT + sp] - mx);
        num = fmaf(e, ov[sp], num);
        den = fmaf(e, l, den);
      }
    }
    o[h * D + d] = num / den;
  }
}

template <int D>
int launch_bf16(const float* q, const void* k, const void* v, const int* kv_len, float* o,
                float* part, unsigned int* counters, int B, int Hq, int Hkv, int S, int kv_row,
                int n_split, float scale, cudaStream_t st) {
  const size_t smem = dk_smem_bytes<D>(Hq / Hkv);
  const int rc = allow_dynamic_smem(decode_bf16_kernel<D>, smem);
  if (rc != 0) return rc;
  decode_bf16_kernel<D><<<dim3(n_split, B * Hkv), DK_THREADS, smem, st>>>(
      q, static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v), kv_len, o,
      part, counters, Hq, Hkv, S, kv_row, scale, n_split);
  return (int)cudaGetLastError();
}

// ---- K8 ----------------------------------------------------------------------

// One block: KV head hk of batch row b over one chunk of keys. T is the cache
// element, int8_t levels with the position scales ks, vs (K8; the chunk code
// also takes __nv_bfloat16 with null scales, K7's phase B). The pointers keep
// their element type down to the shared chunk code: passed as void*, the
// same code came out of ptxas in another instruction order and the bf16 mode
// ran measurably slower (PERF.md).
template <int D, class T>
__global__ void __launch_bounds__(DA_THREADS)
decode_partial_kernel(const float* __restrict__ q, const T* __restrict__ k,
                      const float* __restrict__ ks, const T* __restrict__ v,
                      const float* __restrict__ vs, const int* __restrict__ kv_len,
                      float* __restrict__ part, int Hq, int Hkv, int S, int kv_row,
                      float scale, int n_split) {
  constexpr bool KV8 = std::is_same_v<T, int8_t>;
  extern __shared__ __align__(16) float smem[];
  const int n_rep = Hq / Hkv;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  const int split = blockIdx.x;
  const int len = min(kv_len[b], S);
  const int c0 = split * DA_CHUNK;
  const int nk = min(DA_CHUNK, len - c0);
  const int h0 = b * Hq + hk * n_rep;                  // first query head of the group
  const size_t head_stride = (size_t)n_split * (D + 2);
  float* part0 = part + ((size_t)h0 * n_split + split) * (D + 2);

  if (nk <= 0) {                                       // chunk past kv_len
    for (int r = threadIdx.x; r < n_rep; r += DA_THREADS) {
      part0[r * head_stride + D] = -INFINITY;
      part0[r * head_stride + D + 1] = 0.f;
    }
    return;
  }
  const size_t pos0 = ((size_t)(kv_row + b) * Hkv + hk) * S + c0;   // the chunk's first position
  const size_t base = pos0 * D;
  decode_chunk_partial<D, DA_THREADS, T>(q + (size_t)h0 * D, k + base,
                                         KV8 ? ks + pos0 : nullptr, v + base,
                                         KV8 ? vs + pos0 : nullptr, nk, n_rep, scale, part0,
                                         head_stride, smem);
}

template <int D>
__global__ void decode_combine_kernel(const float* __restrict__ part, float* __restrict__ o,
                                      int n_split) {
  const int bh = blockIdx.x, c = threadIdx.x;
  const float* pp = part + (size_t)bh * n_split * (D + 2);
  float mx = -INFINITY;
  for (int s = 0; s < n_split; ++s)
    if (pp[s * (D + 2) + D + 1] > 0.f) mx = fmaxf(mx, pp[s * (D + 2) + D]);
  float num = 0.f, den = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float l = pp[s * (D + 2) + D + 1];
    if (l > 0.f) {                       // dead chunks leave o unwritten
      const float w = expf(pp[s * (D + 2) + D] - mx);
      num = fmaf(w, pp[s * (D + 2) + c], num);
      den = fmaf(w, l, den);
    }
  }
  o[(size_t)bh * D + c] = den > 0.f ? num / den : 0.f;
}

template <int D>
int launch_q8(const float* q, const void* k, const float* ks, const void* v, const float* vs,
              const int* kv_len, float* o, float* part, int B, int Hq, int Hkv, int S,
              int kv_row, float scale, cudaStream_t st) {
  using T = int8_t;
  const int n_split = (S + DA_CHUNK - 1) / DA_CHUNK;
  const size_t smem = decode_chunk_smem_bytes<D, true>(Hq / Hkv);
  int rc = allow_dynamic_smem(decode_partial_kernel<D, T>, smem);
  if (rc != 0) return rc;
  decode_partial_kernel<D, T><<<dim3(n_split, B * Hkv), DA_THREADS, smem, st>>>(
      q, static_cast<const T*>(k), ks, static_cast<const T*>(v), vs, kv_len, part, Hq, Hkv, S,
      kv_row, scale, n_split);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  decode_combine_kernel<D><<<B * Hq, D, 0, st>>>(part, o, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// K8: q f32 [B, Hq, D], k/v int8 levels [R, Hkv, S, D] with R >= kv_row + B
// and f32 scales ks/vs [R, Hkv, S]; kv_len int32 [B], o f32 [B, Hq, D], part
// f32 [B*Hq, zgml_decode_split_count(S), D + 2]; all contiguous.
ZGML_EXPORT int zgml_decode_attention(const float* q, const void* k, const float* ks,
                                      const void* v, const float* vs, const int* kv_len,
                                      float* o, float* part, int B, int Hq, int Hkv, int S, int D,
                                      int kv_row, float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || kv_row < 0 || ks == nullptr ||
      vs == nullptr)
    return ZGML_ERR_SHAPE;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ZGML_DECODE(DD) \
  case DD: return launch_q8<DD>(q, k, ks, v, vs, kv_len, o, part, B, Hq, Hkv, S, kv_row, scale, st);
  switch (D) {
    ZGML_DECODE(16)
    ZGML_DECODE(32)
    ZGML_DECODE(64)
    ZGML_DECODE(128)
    default: return ZGML_ERR_HEAD_DIM;
  }
#undef ZGML_DECODE
}

// Chunks of K8 (and of K7's phase B) over an S-row cache: part's rows per query head.
ZGML_EXPORT int zgml_decode_split_count(int S) { return (S + DA_CHUNK - 1) / DA_CHUNK; }

// K4: q f32 [B, Hq, D], k/v bf16 [R, Hkv, S, D] with R >= kv_row + B (16-byte
// aligned), kv_len int32 [B], o f32 [B, Hq, D], part f32 [B*Hq, n_split,
// D + 2] (n_split from ops/decode_plan.py decode_splits), counters: B*Hkv
// zeroed uint32 words that each launch leaves zeroed; all contiguous.
ZGML_EXPORT int zgml_decode_attention_bf16(const float* q, const void* k, const void* v,
                                           const int* kv_len, float* o, float* part,
                                           unsigned int* counters, int B, int Hq, int Hkv, int S,
                                           int D, int kv_row, int n_split, float scale,
                                           void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || kv_row < 0 || n_split < 1 ||
      B * Hkv > 65535)
    return ZGML_ERR_SHAPE;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ZGML_DECODE(DD)                                                                    \
  case DD:                                                                                 \
    return launch_bf16<DD>(q, k, v, kv_len, o, part, counters, B, Hq, Hkv, S, kv_row, n_split, \
                           scale, st);
  switch (D) {
    ZGML_DECODE(16)
    ZGML_DECODE(32)
    ZGML_DECODE(64)
    ZGML_DECODE(128)
    default: return ZGML_ERR_HEAD_DIM;
  }
#undef ZGML_DECODE
}
