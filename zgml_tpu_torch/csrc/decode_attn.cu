// K4 decode_attention: one query token per row, GQA, over the bf16 KV cache
// or (its f32 form, decode_attention_f32) over f32 K / V; and K8
// decode_attention_q8 over the int8 cache, in its two modes.
//
// Replaces: zgml_tpu/ops/attention.py `_decode_kernel` (line 282), reached
// through `_decode` / `decode_attention_pallas` (K4), and `_decode_q8_kernel`
// (line 395, pallas_call at 506), reached through `_decode_q8` /
// `decode_attention_q8_pallas` (K8), with its ZGML_TPU_ATTN_I8PV mode (p
// quantized to int8 per JAX key block, attention.py:440-448).
//
// K4's semantics (the plain version is ops/attention.py decode_attention_ref):
//   q f32 [B, Hq, 1, D]; k, v bf16 [R, Hkv, S, D] read in place at batch rows
//   kv_row + b; row b attends keys j < kv_len[b] (int32 on the device, so a
//   decode step needs no host sync). Output f32 [B, Hq, 1, D]; a row with
//   kv_len 0 gives 0. The f32 form takes k, v f32 (the JAX kernel widens
//   whatever cache it is given, attention.py:306-307; Whisper's decoder reads
//   an f32 self-attention cache and f32 cross-attention K / V): the same
//   kernel text at T = float, keys past kv_len, and past S where S is not a
//   multiple of the 32-key group, never read.
//
// What bounds it on the H100: HBM bytes, 2 * kv_len * D * 2 per KV head per
// row for ~4 flops per byte (2.1 MB, 0.6 us, at TinyLlama-1.1B's 4 heads and
// 2047 keys); but at decode sizes its time is latency: a launch, a round
// trip for the keys, one for the merge.
//
// What K4's design does about it (decode_kv_kernel, one launch): the grid
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
// K8 (the plain version is ops/attention.py decode_attention_q8_ref) runs on
// K4's plan in one launch (decode_q8_kernel<D, I8PV>): k, v are the
// position-major int8 cache [R, Hkv, S, D] with f32 scales ks, vs [R, Hkv, S].
// The block quantizes q per query head itself (decode_split.cuh
// quantize_vec, as attention.py:529-533), and a lane scores its key by exact
// `__dp4a` dots times (q_scale * k_scale) * scale, the scales read per
// position. Its bytes bound is K4's at about half the bytes (D + 4 a
// position and KV head, against 2 * D). A step of the block takes up to 256
// keys, up to two 32-key groups a warp, the K and V tiles and their scales
// copied by cp.async (at head_dim <= 64 with the next step in flight; at 128
// one step's tiles, so two blocks fit an SM and the plan takes twice the
// splits).
//   f32-p (the default): p * v_scale against the levels in f32, the function
//   of attention.py:449-452, which does not depend on how the keys are cut:
//   K4's split of 32-key groups, each warp its own online softmax.
//   I8PV: p * v_scale is quantized to int8 per JAX key block (bs keys,
//   attention.py:536-545, ops/attention.k8_block: 256, 128, or S below 256)
//   against the block's own max over all its positions, masked ones
//   included (psc = max / 127, pq = rint(pv / psc)), P.V runs as an int8 dot
//   into int32 and the block adds o_i32 * psc. So a split takes whole JAX
//   blocks and a step is one block: the warps score their groups, the
//   block's max of the scores and then of p * v_scale are taken across the
//   warps in shared memory (two barriers a block), every warp steps its
//   running max as the block's, and each warp's integer P.V is exact in any
//   order (256 * 127 * 127 < 2^31): `__dp4a` over 4 keys, each lane owning
//   D/32 dims, V's 4 rows packed by `__byte_perm`. A split's running max
//   starts at its first block (the plain version of the plan:
//   decode_attention_q8_ref(split=n_split)); p's roundings then differ from
//   the unsplit function where p * v_scale / psc sits at a half.
#include "decode_split.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int DK_WARPS = 4;              // ops/decode_plan.py DECODE_WARPS
constexpr int DK_THREADS = DK_WARPS * 32;
constexpr int DK_GROUP = 32;             // keys a warp scores at once, one a lane
constexpr int DK_RG = 8;                 // query heads a pass over the keys
constexpr int DK_MAX_SPLIT = 16;         // ops/decode_plan.py DECODE_MAX_SPLIT

// Dynamic shared memory of decode_kv_kernel<D, T>: q [n_rep][D] f32; each
// warp's dk_nbuf K tiles [32][D + 16 / sizeof(T)] (rows padded by 16 bytes: the
// lanes' row reads hit 32 banks) and as many V tiles [32][D], of the cache's
// element T (bf16, or f32 for the f32 form); p [DK_WARPS][DK_RG][32], the
// warps' max and sum [DK_WARPS][DK_RG] each and their o [DK_WARPS][DK_RG][D];
// the merge flag. The f32 form's tiles are twice the bf16 one's: at head_dim
// 128 two buffers a warp would take 266,240 bytes, past the 227 KB an SM has,
// so that instantiation keeps one buffer a warp (the next group's copy waits
// for the current one's P.V).
template <int D, typename T>
__host__ __device__ constexpr int dk_krow() { return D + 16 / (int)sizeof(T); }
template <int D, typename T>
__host__ __device__ constexpr int dk_nbuf() { return sizeof(T) == 4 && D >= 128 ? 1 : 2; }
template <int D, typename T>
size_t dk_smem_bytes(int n_rep) {
  return sizeof(float) * ((size_t)n_rep * D + DK_WARPS * DK_RG * (DK_GROUP + 2 + D) +
                          (size_t)n_rep * 2 * DK_MAX_SPLIT) +
         sizeof(T) * (size_t)DK_WARPS * dk_nbuf<D, T>() * DK_GROUP * (dk_krow<D, T>() + D) + 16;
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

template <int DPL>
__device__ __forceinline__ void load_v(const float* p, float (&vv)[DPL]) {
  if constexpr (DPL == 1) {
    vv[0] = *p;
  } else if constexpr (DPL == 2) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    vv[0] = u.x;
    vv[1] = u.y;
  } else {
    const float4 u = *reinterpret_cast<const float4*>(p);
    vv[0] = u.x;
    vv[1] = u.y;
    vv[2] = u.z;
    vv[3] = u.w;
  }
}

// eight consecutive elements of a K row (16-byte aligned) as f32
__device__ __forceinline__ void load_k8(const __nv_bfloat16* p, float (&kf)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  kf[0] = bf16_lo(u.x);
  kf[1] = bf16_hi(u.x);
  kf[2] = bf16_lo(u.y);
  kf[3] = bf16_hi(u.y);
  kf[4] = bf16_lo(u.z);
  kf[5] = bf16_hi(u.z);
  kf[6] = bf16_lo(u.w);
  kf[7] = bf16_hi(u.w);
}

__device__ __forceinline__ void load_k8(const float* p, float (&kf)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  kf[0] = a.x;
  kf[1] = a.y;
  kf[2] = a.z;
  kf[3] = a.w;
  kf[4] = b.x;
  kf[5] = b.y;
  kf[6] = b.z;
  kf[7] = b.w;
}

// Whether split s of n holds any of a row's G units (decode_split_keys).
__device__ __forceinline__ bool split_live(int s, int n, int G) {
  return (unsigned)((s + 1) * G) / n > (unsigned)(s * G) / n;    // G <= S / 32, n <= 16
}

// One warp's copies of group gi's K and V tiles (keys gi * 32 .. + 31 of the
// head, rows at or past len zero-filled and not read) into kt / vt.
template <int D, typename T>
__device__ __forceinline__ void copy_group(const T* kb, const T* vb, int gi, int len, T* kt,
                                           T* vt, int lane) {
  constexpr int EPC = 16 / (int)sizeof(T);             // elements a 16-byte chunk
  constexpr int CH = D / EPC;                          // chunks a row
  for (int i = lane; i < DK_GROUP * CH; i += 32) {
    const int r = i / CH, c = i % CH, j = gi * DK_GROUP + r;
    const bool live = j < len;
    const size_t at = (size_t)(live ? j : 0) * D + c * EPC;
    tf32::cp_async16(kt + r * dk_krow<D, T>() + c * EPC, kb + at, live);
    tf32::cp_async16(vt + r * D + c * EPC, vb + at, live);
  }
}

// ---- K4 ----------------------------------------------------------------------

template <int D, typename T>
__global__ void __launch_bounds__(DK_THREADS)
decode_kv_kernel(const float* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ kv_len, float* __restrict__ o,
                 float* __restrict__ part, unsigned int* counters, int Hq, int Hkv, int S,
                 int kv_row, float scale, int n_split) {
  constexpr int DPL = D >= 32 ? D / 32 : 1;
  constexpr int NB = dk_nbuf<D, T>();
  constexpr int KT = DK_GROUP * dk_krow<D, T>(), VT = DK_GROUP * D;   // elements a tile
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
  T* kt = reinterpret_cast<T*>(wo + DK_WARPS * DK_RG * D) +
          (size_t)warp * NB * (KT + VT);               // this warp's tiles: K0 V0 (K1 V1)
  int* flag = reinterpret_cast<int*>(reinterpret_cast<T*>(wo + DK_WARPS * DK_RG * D) +
                                     (size_t)DK_WARPS * NB * (KT + VT));
  const size_t pos0 = ((size_t)(kv_row + b) * Hkv + hk) * S;
  const T* kb = k + pos0 * D;
  const T* vb = v + pos0 * D;
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
    // this warp's first NB groups in flight (with q, at r0 = 0)
    if (gf < g_end) copy_group<D, T>(kb, vb, gf, len, kt, kt + KT, lane);
    tf32::cp_async_commit();
    if constexpr (NB == 2) {
      if (gf + step < g_end)
        copy_group<D, T>(kb, vb, gf + step, len, kt + KT + VT, kt + 2 * KT + VT, lane);
      tf32::cp_async_commit();
    }
    tf32::cp_async_wait<NB - 1>();
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
    for (int gi = gf; gi < g_end; gi += step, buf ^= NB - 1) {
      const T* kg = kt + buf * (KT + VT);
      const T* vg = kg + KT;
      const int j = gi * DK_GROUP + lane;
      const bool valid = j < len;
      float s[DK_RG];
#pragma unroll
      for (int r = 0; r < DK_RG; ++r) s[r] = 0.f;
      {                                                // lane j's key against the heads
        const T* kr = kg + lane * dk_krow<D, T>();
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          float kf[8];
          load_k8(kr + 8 * c, kf);
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
      if (gi + NB * step < g_end)                      // this buffer's next group
        copy_group<D, T>(kb, vb, gi + NB * step, len, kt + buf * (KT + VT),
                         kt + buf * (KT + VT) + KT, lane);
      tf32::cp_async_commit();
      tf32::cp_async_wait<NB - 1>();
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
  // the last live split of (row, KV head) to arrive merges them in split order.
  // This tail and the warp merge above are K8's block_partial and
  // merge_splits written out: the two copies change together (calling the
  // functions made K4 5-8% slower; PERF.md, K8's row).
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

template <int D, typename T>
int launch_kv(const float* q, const void* k, const void* v, const int* kv_len, float* o,
              float* part, unsigned int* counters, int B, int Hq, int Hkv, int S, int kv_row,
              int n_split, float scale, cudaStream_t st) {
  const size_t smem = dk_smem_bytes<D, T>(Hq / Hkv);
  const int rc = allow_dynamic_smem(decode_kv_kernel<D, T>, smem);
  if (rc != 0) return rc;
  decode_kv_kernel<D, T><<<dim3(n_split, B * Hkv), DK_THREADS, smem, st>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v), kv_len, o, part, counters, Hq, Hkv,
      S, kv_row, scale, n_split);
  return (int)cudaGetLastError();
}

// ---- K8 ----------------------------------------------------------------------

// K8's tail, K4's (decode_kv_kernel) in functions: K4 keeps its inline
// text, which ran 5-8% faster than through these (PERF.md), so the two
// copies change together.
//
// The block's partial for query heads r0 .. r0 + nr - 1 of its group (h0 the
// group's first): each warp's running max mr, lane sums lr and o orr over
// the heads [ra, rb) it holds (the others count a sum of 0), merged in warp
// order; written as o where one split holds the row (live == 1), else as the
// split's (unnormalised o, max, sum) in part. Ends with a barrier: the areas
// serve the next heads.
template <int D, int DPL>
__device__ __forceinline__ void block_partial(const float (&mr)[DK_RG], const float (&lr)[DK_RG],
                                              const float (&orr)[DK_RG][DPL], int nr, int ra,
                                              int rb, int r0, int h0, int dl, float* wm,
                                              float* wl, float* wo, float* __restrict__ o,
                                              float* __restrict__ part, int live, int split,
                                              int n_split) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < DK_RG; ++r)                      // heads outside [ra, rb): sum 0
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
  __syncthreads();
}

// After every head's partial of a block with live > 1 splits: the last live
// split of (row, KV head) bh to arrive (a ticket on counters[bh], left at 0)
// merges them in split order (the splits that hold any of the row's G units).
// flag: an int of shared memory, then n_rep * 2 * DK_MAX_SPLIT floats.
template <int D>
__device__ __forceinline__ void merge_splits(const float* __restrict__ part,
                                             float* __restrict__ o, unsigned int* counters,
                                             int bh, int h0, int n_rep, int live, int n_split,
                                             int G, int* flag) {
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

constexpr int DQ_GPW = 2;                            // groups a warp takes in one step
constexpr int DQ_STEP = DK_WARPS * DQ_GPW * DK_GROUP;   // keys a step at most (the f32-p step)
// steps a warp's tiles hold: the next one in flight; one at head_dim 128,
// where two would take 143 KB and leave one block an SM (ops/attention.py
// decode_q8_splits counts two an SM at every head dim). Two steps of one
// group a warp there instead (the same tiles), with q quantized after the
// copies as below, ran 7B kv_len 2047 14% slower on the H100, 6% of it the
// late q (PERF.md)
template <int D>
__host__ __device__ constexpr int dq_stages() { return D >= 128 ? 1 : 2; }

// One 32-key group in shared memory: K rows padded by 16 bytes (the lanes'
// 16-byte row reads hit 32 banks), V rows, then the 32 K scales and the 32
// V scales.
template <int D>
__host__ __device__ constexpr int dq_krow() { return D + 16; }
template <int D>
__host__ __device__ constexpr int dq_group_bytes() {
  return DK_GROUP * (dq_krow<D>() + D) + 2 * DK_GROUP * (int)sizeof(float);
}
__host__ __device__ inline size_t dq_round16(size_t n) { return (n + 15) / 16 * 16; }

// Dynamic shared memory of decode_q8_kernel<D, I8PV>: q levels [n_rep][D]
// and scales [n_rep] (each rounded up to 16 bytes); per warp and head 64
// floats of p * v_scale (I8PV: 64 int8 levels pq); the block maxima of the
// scores and of p * v_scale [2][DK_WARPS][DK_RG] (I8PV); the warps' max, sum
// and o as K4's; each warp's dq_stages steps of DQ_GPW groups; the merge flag
// and its n_rep * 2 * DK_MAX_SPLIT floats.
template <int D>
size_t dq_smem_bytes(int n_rep) {
  return dq_round16((size_t)n_rep * D) + dq_round16((size_t)n_rep * sizeof(float)) +
         sizeof(float) * DK_WARPS * DK_RG * (2 * DK_GROUP + 4 + D) +
         (size_t)DK_WARPS * dq_stages<D>() * DQ_GPW * dq_group_bytes<D>() + 16 +
         sizeof(float) * (size_t)n_rep * 2 * DK_MAX_SPLIT;
}

// One warp's copies of the group of keys j0 .. j0 + 31 of the head (rows at
// or past end zero-filled, their scales 0) into g (dq_group_bytes): the K
// rows and both scales, or (v_rows) the V rows, which P.V reads after the
// scores, so each is a commit group of its own.
template <int D>
__device__ __forceinline__ void copy_group_q8(const int8_t* kb, const int8_t* vb, const float* ksb,
                                              const float* vsb, int j0, int end, unsigned char* g,
                                              int lane, bool v_rows) {
  constexpr int CH = D / 16;                           // 16-byte chunks a row
  for (int i = lane; i < DK_GROUP * CH; i += 32) {
    const int r = i / CH, c = i % CH, j = j0 + r;
    const bool live = j < end;
    const size_t at = (size_t)(live ? j : 0) * D + c * 16;
    if (v_rows)
      tf32::cp_async16(g + DK_GROUP * dq_krow<D>() + r * D + c * 16, vb + at, live);
    else
      tf32::cp_async16(g + r * dq_krow<D>() + c * 16, kb + at, live);
  }
  if (v_rows) return;
  const int j = j0 + lane;
  const bool live = j < end;
  float* sc = reinterpret_cast<float*>(g + DK_GROUP * (dq_krow<D>() + D));
  tf32::cp_async4(sc + lane, ksb + (live ? j : 0), live);
  tf32::cp_async4(sc + DK_GROUP + lane, vsb + (live ? j : 0), live);
}

// The DPL int8 levels at p (this lane's dims of one V row) as floats.
template <int DPL>
__device__ __forceinline__ void load_v8(const int8_t* p, float (&vv)[DPL]) {
  if constexpr (DPL == 1) {
    vv[0] = (float)p[0];
  } else if constexpr (DPL == 2) {
    const uint32_t u = *reinterpret_cast<const unsigned short*>(p);
    vv[0] = (float)(int8_t)(u & 0xFFu);
    vv[1] = (float)(int8_t)(u >> 8);
  } else {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) vv[i] = (float)(int8_t)(u >> (8 * i));
  }
}

// V's 4 rows p, p + D, p + 2D, p + 3D at this lane's DPL dims, packed per
// dim: w[i] holds dim i of the 4 keys in key order (a __dp4a operand).
template <int D, int DPL>
__device__ __forceinline__ void v_quad(const int8_t* p, uint32_t (&w)[DPL]) {
  if constexpr (DPL == 1) {
    w[0] = (uint32_t)(uint8_t)p[0] | (uint32_t)(uint8_t)p[D] << 8 |
           (uint32_t)(uint8_t)p[2 * D] << 16 | (uint32_t)(uint8_t)p[3 * D] << 24;
  } else if constexpr (DPL == 2) {
    const uint32_t a = *reinterpret_cast<const unsigned short*>(p) |
                       (uint32_t)*reinterpret_cast<const unsigned short*>(p + D) << 16;
    const uint32_t b = *reinterpret_cast<const unsigned short*>(p + 2 * D) |
                       (uint32_t)*reinterpret_cast<const unsigned short*>(p + 3 * D) << 16;
    w[0] = __byte_perm(a, b, 0x6420);
    w[1] = __byte_perm(a, b, 0x7531);
  } else {
    const uint32_t a0 = *reinterpret_cast<const uint32_t*>(p);
    const uint32_t a1 = *reinterpret_cast<const uint32_t*>(p + D);
    const uint32_t a2 = *reinterpret_cast<const uint32_t*>(p + 2 * D);
    const uint32_t a3 = *reinterpret_cast<const uint32_t*>(p + 3 * D);
    const uint32_t t0 = __byte_perm(a0, a1, 0x5140), t1 = __byte_perm(a2, a3, 0x5140);
    const uint32_t t2 = __byte_perm(a0, a1, 0x7362), t3 = __byte_perm(a2, a3, 0x7362);
    w[0] = __byte_perm(t0, t1, 0x5410);
    w[1] = __byte_perm(t0, t1, 0x7632);
    w[2] = __byte_perm(t2, t3, 0x5410);
    w[3] = __byte_perm(t2, t3, 0x7632);
  }
}

// Two blocks an SM (ops/attention.py decode_q8_splits): the bound leaves
// ptxas up to 255 registers; left to itself it capped the I8PV form at 168
// and spilled 140 bytes at head_dim 64.
template <int D, bool I8PV>
__global__ void __launch_bounds__(DK_THREADS, 2)
decode_q8_kernel(const float* __restrict__ q, const int8_t* __restrict__ k,
                 const float* __restrict__ ks, const int8_t* __restrict__ v,
                 const float* __restrict__ vs, const int* __restrict__ kv_len,
                 float* __restrict__ o, float* __restrict__ part, unsigned int* counters,
                 int Hq, int Hkv, int S, int kv_row, float scale, int n_split, int bs) {
  constexpr int DPL = D >= 32 ? D / 32 : 1;
  constexpr int GB = dq_group_bytes<D>();
  constexpr int PW = DQ_GPW * DK_GROUP;                // keys of a warp's step
  constexpr int NS = dq_stages<D>();
  extern __shared__ __align__(16) unsigned char dsm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_rep = Hq / Hkv;
  const int bh = blockIdx.y, b = bh / Hkv, hk = bh % Hkv, split = blockIdx.x;
  const int h0 = b * Hq + hk * n_rep;                  // first query head of the group
  int8_t* qw = reinterpret_cast<int8_t*>(dsm);         // [n_rep][D] q levels
  float* qsc = reinterpret_cast<float*>(dsm + dq_round16((size_t)n_rep * D));   // [n_rep]
  float* pvs = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(qsc) +
                                        dq_round16((size_t)n_rep * sizeof(float)));
  float* red = pvs + DK_WARPS * DK_RG * PW;            // [2][DK_WARPS][DK_RG]
  float* wm = red + 2 * DK_WARPS * DK_RG;
  float* wl = wm + DK_WARPS * DK_RG;
  float* wo = wl + DK_WARPS * DK_RG;                   // [DK_WARPS][DK_RG][D]
  unsigned char* tiles = reinterpret_cast<unsigned char*>(wo + DK_WARPS * DK_RG * D);
  int* flag = reinterpret_cast<int*>(tiles + (size_t)DK_WARPS * NS * DQ_GPW * GB);

  const int len = min(max(__ldg(kv_len + b), 0), S);
  // q quantized per query head (a warp a head), its loads in flight with
  // kv_len's; quantized after the first tiles' copies are issued instead, it
  // waits behind them: 7B kv_len 2047 6% slower on the H100 (PERF.md)
  for (int r = warp; r < n_rep; r += DK_WARPS)
    quantize_vec<D>(q + (size_t)(h0 + r) * D, qw + r * D, qsc + r, lane);
  // the split's units: whole JAX blocks (I8PV) or 32-key groups, balanced
  const int U = I8PV ? bs : DK_GROUP;
  const int NU = (len + U - 1) / U;
  const int u0 = (int)((unsigned)(split * NU) / n_split);
  const int u1 = (int)((unsigned)((split + 1) * NU) / n_split);
  if (u0 == u1) {                                      // no key here (kv_len 0: split 0 writes 0)
    if (NU == 0 && split == 0)
      for (int i = threadIdx.x; i < n_rep * D; i += DK_THREADS) o[(size_t)h0 * D + i] = 0.f;
    return;
  }
  const int live = min(n_split, NU);                   // splits that hold keys
  const int k0 = u0 * U, k1 = min(u1 * U, len);
  const int CK = I8PV ? bs : DQ_STEP;                  // keys a step: one JAX block (I8PV)
  const int n_steps = (k1 - k0 + CK - 1) / CK;
  // a block with fewer groups than warps (one step) gives each group hs
  // warps, which split its query heads: in a step warp w takes the step's
  // groups w / hs and w / hs + DK_WARPS / hs, and heads [ra, rb) of each pass
  const int gt = (k1 - k0 + DK_GROUP - 1) / DK_GROUP;
  const int hs = gt >= DK_WARPS ? 1 : DK_WARPS / gt;
  const int gw = warp / hs, gstep = DK_WARPS / hs;
  const size_t pos0 = ((size_t)(kv_row + b) * Hkv + hk) * S;
  const int8_t* kb = k + pos0 * D;
  const int8_t* vb = v + pos0 * D;
  unsigned char* mine_t = tiles + (size_t)warp * NS * DQ_GPW * GB;  // [NS steps][DQ_GPW] groups
  float* pw = pvs + warp * DK_RG * PW;                 // this warp's [DK_RG][PW] p * v_scale
  const int dl = (lane * DPL) % D;                     // this lane's first dim in P.V

  for (int r0 = 0; r0 < n_rep; r0 += DK_RG) {
    const int nr = min(DK_RG, n_rep - r0);
    const int per = (nr + hs - 1) / hs;
    const int ra = min(nr, (warp % hs) * per), rb = min(nr, ra + per);
    const bool heads = ra < rb;                        // a warp without heads takes no group
    // this warp's groups of step st into buffer st % NS: two commit groups,
    // the K rows and scales, then the V rows
    auto copy_step = [&](int st) {
      const int c0 = k0 + st * CK, c1 = min(c0 + CK, k1);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (heads && st < n_steps)
#pragma unroll
          for (int g = 0; g < DQ_GPW; ++g) {
            const int j0 = c0 + (gw + g * gstep) * DK_GROUP;
            if (j0 < c1)
              copy_group_q8<D>(kb, vb, ks + pos0, vs + pos0, j0, c1,
                               mine_t + ((st % NS) * DQ_GPW + g) * GB, lane, half == 1);
          }
        tf32::cp_async_commit();
      }
    };
#pragma unroll
    for (int st = 0; st < NS; ++st) copy_step(st);
    __syncthreads();                                   // q from every warp
    float mr[DK_RG], lr[DK_RG], orr[DK_RG][DPL];
#pragma unroll
    for (int r = 0; r < DK_RG; ++r) {
      mr[r] = -INFINITY;
      lr[r] = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) orr[r][i] = 0.f;
    }
    for (int st = 0; st < n_steps; ++st) {
      tf32::cp_async_wait<2 * NS - 1>();               // this step's K rows and scales
      __syncwarp();
      const int c0 = k0 + st * CK, c1 = min(c0 + CK, k1);
      const unsigned char* gp[DQ_GPW];
      int nk[DQ_GPW];                                  // live keys of each group (0: none)
#pragma unroll
      for (int g = 0; g < DQ_GPW; ++g) {
        const int j0 = c0 + (gw + g * gstep) * DK_GROUP;
        nk[g] = heads && j0 < c1 ? min(DK_GROUP, c1 - j0) : 0;
        gp[g] = mine_t + ((st % NS) * DQ_GPW + g) * GB;
      }
      // scores: lane's key of each group against the heads (each 16 bytes
      // of q read once for both groups), exact integer dots times (q_scale *
      // k_scale) * scale (attention.py:425-427)
      int dot[DQ_GPW][DK_RG];
#pragma unroll
      for (int g = 0; g < DQ_GPW; ++g)
#pragma unroll
        for (int r = 0; r < DK_RG; ++r) dot[g][r] = 0;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        uint4 u[DQ_GPW];
#pragma unroll
        for (int g = 0; g < DQ_GPW; ++g)
          u[g] = nk[g] > 0 ? reinterpret_cast<const uint4*>(gp[g] + lane * dq_krow<D>())[c]
                           : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int r = 0; r < DK_RG; ++r)
          if (r >= ra && r < rb) {
            const int4 qv = *reinterpret_cast<const int4*>(qw + (r0 + r) * D + 16 * c);
#pragma unroll
            for (int g = 0; g < DQ_GPW; ++g) {
              dot[g][r] = __dp4a(qv.x, (int)u[g].x, dot[g][r]);
              dot[g][r] = __dp4a(qv.y, (int)u[g].y, dot[g][r]);
              dot[g][r] = __dp4a(qv.z, (int)u[g].z, dot[g][r]);
              dot[g][r] = __dp4a(qv.w, (int)u[g].w, dot[g][r]);
            }
          }
      }
      float s[DQ_GPW][DK_RG], vsc[DQ_GPW];
#pragma unroll
      for (int g = 0; g < DQ_GPW; ++g) {
        const float* gsc = reinterpret_cast<const float*>(gp[g] + DK_GROUP * (dq_krow<D>() + D));
        const bool valid = lane < nk[g];
        const float ksj = valid ? gsc[lane] : 0.f;
        vsc[g] = valid ? gsc[DK_GROUP + lane] : 0.f;
#pragma unroll
        for (int r = 0; r < DK_RG; ++r)
          s[g][r] = valid ? (float)dot[g][r] * ((qsc[r0 + min(r, nr - 1)] * ksj) * scale)
                          : -INFINITY;
      }
      if constexpr (!I8PV) {
        if (nk[0] > 0) {                               // warp-uniform: the warp has a group
          // online softmax over the warp's keys of the step
#pragma unroll
          for (int r = 0; r < DK_RG; ++r)
            if (r >= ra && r < rb) {
              const float mn = fmaxf(mr[r], warp_max(fmaxf(s[0][r], s[1][r])));
              const float alpha = expf(mr[r] - mn);
              const float p0 = expf(s[0][r] - mn), p1 = expf(s[1][r] - mn);
              lr[r] = fmaf(lr[r], alpha, p0) + p1;
#pragma unroll
              for (int i = 0; i < DPL; ++i) orr[r][i] *= alpha;
              mr[r] = mn;
              pw[r * PW + lane] = p0 * vsc[0];
              pw[r * PW + DK_GROUP + lane] = nk[1] > 0 ? p1 * vsc[1] : 0.f;
            }
          tf32::cp_async_wait<2 * NS - 2>();           // and its V rows
          __syncwarp();
          // (p * v_scale) V in f32 on the levels: lanes own dims, KQ keys a
          // step, in key order (a key past the live ones adds p = 0 times a
          // zero row). KQ is 4 at head_dim 128, where one head (7B) leaves
          // the loop's latency bare: 15.6 against 16.9 us at kv_len 2047 on
          // the H100, but 1 below, where 4 cost TinyLlama's batch 4 ~1.3 us
          // (PERF.md)
          constexpr int KQ = D >= 128 ? 4 : 1;
#pragma unroll
          for (int g = 0; g < DQ_GPW; ++g) {
            const int8_t* vg = reinterpret_cast<const int8_t*>(gp[g] + DK_GROUP * dq_krow<D>());
            for (int j0 = 0; j0 < nk[g]; j0 += KQ) {
              float vv[KQ][DPL];
#pragma unroll
              for (int t = 0; t < KQ; ++t) load_v8<DPL>(vg + (j0 + t) * D + dl, vv[t]);
#pragma unroll
              for (int r = 0; r < DK_RG; ++r)
                if (r >= ra && r < rb) {
                  float p[KQ];
                  if constexpr (KQ == 4) {
                    const float4 p4 =
                        *reinterpret_cast<const float4*>(pw + r * PW + g * DK_GROUP + j0);
                    p[0] = p4.x, p[1] = p4.y, p[2] = p4.z, p[3] = p4.w;
                  } else {
                    p[0] = pw[r * PW + g * DK_GROUP + j0];
                  }
#pragma unroll
                  for (int i = 0; i < DPL; ++i)
#pragma unroll
                    for (int t = 0; t < KQ; ++t) orr[r][i] = fmaf(p[t], vv[t][i], orr[r][i]);
                }
            }
          }
        }
      } else {
        // the JAX block's max of the scores per head, across the warps
#pragma unroll
        for (int r = 0; r < DK_RG; ++r) {
          const float mx = warp_max(fmaxf(s[0][r], s[1][r]));
          if (lane == 0) red[warp * DK_RG + r] = r >= ra && r < rb ? mx : -INFINITY;
        }
        __syncthreads();
        // the running max steps to the block's; p, its sum, p * v_scale
        // (kept in s) and the block's max of it across the warps
#pragma unroll
        for (int r = 0; r < DK_RG; ++r)
          if (r >= ra && r < rb) {
            float bm = red[r];
#pragma unroll
            for (int w = 1; w < DK_WARPS; ++w) bm = fmaxf(bm, red[w * DK_RG + r]);
            const float mn = fmaxf(mr[r], bm);         // finite: the block's first key is live
            const float alpha = expf(mr[r] - mn);
            const float p0 = expf(s[0][r] - mn), p1 = expf(s[1][r] - mn);
            lr[r] = fmaf(lr[r], alpha, p0) + p1;
#pragma unroll
            for (int i = 0; i < DPL; ++i) orr[r][i] *= alpha;
            mr[r] = mn;
            s[0][r] = nk[0] > 0 ? p0 * vsc[0] : 0.f;
            s[1][r] = nk[1] > 0 ? p1 * vsc[1] : 0.f;
          }
#pragma unroll
        for (int r = 0; r < DK_RG; ++r) {
          const float mx = warp_max(fmaxf(s[0][r], s[1][r]));
          if (lane == 0) red[(DK_WARPS + warp) * DK_RG + r] = r >= ra && r < rb ? mx : 0.f;
        }
        __syncthreads();
        // pq = rint(pv / psc) against the block's psc = max(pv) / 127 (pv >= 0),
        // taken from the warps' maxima again where P.V adds o_i32 * psc (the
        // same bits, and no register a head across the P.V)
        int8_t* pq = reinterpret_cast<int8_t*>(pw);    // [DK_RG][PW] levels
        auto block_psc = [&](int r) {
          float pm = red[DK_WARPS * DK_RG + r];
#pragma unroll
          for (int w = 1; w < DK_WARPS; ++w) pm = fmaxf(pm, red[(DK_WARPS + w) * DK_RG + r]);
          return pm / 127.0f;
        };
#pragma unroll
        for (int r = 0; r < DK_RG; ++r)
          if (r >= ra && r < rb) {
            const float psc = block_psc(r);
            const float pinv = psc > 0.f ? 1.0f / psc : 0.f;
            pq[r * PW + lane] = (int8_t)rintf(s[0][r] * pinv);
            pq[r * PW + DK_GROUP + lane] = (int8_t)rintf(s[1][r] * pinv);
          }
        tf32::cp_async_wait<2 * NS - 2>();             // this step's V rows
        __syncwarp();
        // pq V exact in int32: 4 keys a __dp4a, V's rows packed per dim
        int acc[DK_RG][DPL];
#pragma unroll
        for (int r = 0; r < DK_RG; ++r)
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[r][i] = 0;
#pragma unroll
        for (int g = 0; g < DQ_GPW; ++g) {
          const int8_t* vg = reinterpret_cast<const int8_t*>(gp[g] + DK_GROUP * dq_krow<D>());
          const int nq = (nk[g] + 3) / 4;              // rows past the last live key are 0
          for (int qd = 0; qd < nq; ++qd) {
            uint32_t vw[DPL];
            v_quad<D, DPL>(vg + 4 * qd * D + dl, vw);
#pragma unroll
            for (int r = 0; r < DK_RG; ++r)
              if (r >= ra && r < rb) {
                const int pword =
                    *reinterpret_cast<const int*>(pq + r * PW + g * DK_GROUP + 4 * qd);
#pragma unroll
                for (int i = 0; i < DPL; ++i) acc[r][i] = __dp4a(pword, (int)vw[i], acc[r][i]);
              }
          }
        }
#pragma unroll
        for (int r = 0; r < DK_RG; ++r)
          if (r >= ra && r < rb)
#pragma unroll
            for (int i = 0; i < DPL; ++i)
              orr[r][i] = fmaf((float)acc[r][i], block_psc(r), orr[r][i]);
      }
      __syncwarp();                                    // the tiles and p are read
      copy_step(st + NS);                              // into this step's buffer
    }
    tf32::cp_async_wait<0>();
    block_partial<D, DPL>(mr, lr, orr, nr, ra, rb, r0, h0, dl, wm, wl, wo, o, part, live, split,
                          n_split);
  }
  if (live == 1) return;
  merge_splits<D>(part, o, counters, bh, h0, n_rep, live, n_split, NU, flag);
}

template <int D, bool I8PV>
int launch_q8(const float* q, const void* k, const float* ks, const void* v, const float* vs,
              const int* kv_len, float* o, float* part, unsigned int* counters, int B, int Hq,
              int Hkv, int S, int kv_row, int n_split, int bs, float scale, cudaStream_t st) {
  const size_t smem = dq_smem_bytes<D>(Hq / Hkv);
  const int rc = allow_dynamic_smem(decode_q8_kernel<D, I8PV>, smem);
  if (rc != 0) return rc;
  decode_q8_kernel<D, I8PV><<<dim3(n_split, B * Hkv), DK_THREADS, smem, st>>>(
      q, static_cast<const int8_t*>(k), ks, static_cast<const int8_t*>(v), vs, kv_len, o, part,
      counters, Hq, Hkv, S, kv_row, scale, n_split, bs);
  return (int)cudaGetLastError();
}

}  // namespace

// K8: q f32 [B, Hq, D], k/v int8 levels [R, Hkv, S, D] with R >= kv_row + B
// and f32 scales ks/vs [R, Hkv, S]; kv_len int32 [B], o f32 [B, Hq, D], part
// f32 [B*Hq, n_split, D + 2] (n_split from ops/decode_plan.py decode_splits,
// at most 16), counters: B*Hkv zeroed uint32 words that each launch leaves
// zeroed; all contiguous, k / v 16-byte aligned. i8pv: the
// ZGML_TPU_ATTN_I8PV mode, p quantized per JAX block of bs keys (1..256).
ZGML_EXPORT int zgml_decode_attention_q8(const float* q, const void* k, const float* ks,
                                         const void* v, const float* vs, const int* kv_len,
                                         float* o, float* part, unsigned int* counters, int B,
                                         int Hq, int Hkv, int S, int D, int kv_row, int n_split,
                                         int bs, int i8pv, float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || kv_row < 0 || ks == nullptr ||
      vs == nullptr || n_split < 1 || n_split > DK_MAX_SPLIT || B * Hkv > 65535 ||
      (i8pv && (bs < 1 || bs > DQ_STEP)))
    return ZGML_ERR_SHAPE;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ZGML_DECODE(DD)                                                                        \
  case DD:                                                                                     \
    return i8pv ? launch_q8<DD, true>(q, k, ks, v, vs, kv_len, o, part, counters, B, Hq, Hkv, \
                                      S, kv_row, n_split, bs, scale, st)                       \
                : launch_q8<DD, false>(q, k, ks, v, vs, kv_len, o, part, counters, B, Hq,     \
                                       Hkv, S, kv_row, n_split, bs, scale, st);
  switch (D) {
    ZGML_DECODE(16)
    ZGML_DECODE(32)
    ZGML_DECODE(64)
    ZGML_DECODE(128)
    default: return ZGML_ERR_HEAD_DIM;
  }
#undef ZGML_DECODE
}

// Chunks of K7's phase B (decode_split.cuh) over an S-row cache: part's rows per query head.
ZGML_EXPORT int zgml_decode_split_count(int S) { return (S + DA_CHUNK - 1) / DA_CHUNK; }

// K4: q f32 [B, Hq, D], k/v bf16 (zgml_decode_attention_bf16) or f32
// (zgml_decode_attention_f32, the f32 form) [R, Hkv, S, D] with R >= kv_row +
// B (16-byte aligned), kv_len int32 [B], o f32 [B, Hq, D], part f32 [B*Hq,
// n_split, D + 2] (n_split from ops/decode_plan.py decode_splits, at most 16),
// counters: B*Hkv zeroed uint32 words that each launch leaves zeroed; all
// contiguous. One export a cache element type, each launching
// decode_kv_kernel<D, T> with T fixed at compile time (a `void*` cache typed
// at run time ran 14-16% slower).
template <typename T>
static int decode_kv(const float* q, const void* k, const void* v, const int* kv_len, float* o,
              float* part, unsigned int* counters, int B, int Hq, int Hkv, int S, int D,
              int kv_row, int n_split, float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || kv_row < 0 || n_split < 1 ||
      n_split > DK_MAX_SPLIT || B * Hkv > 65535)
    return ZGML_ERR_SHAPE;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ZGML_DECODE(DD)                                                                   \
  case DD:                                                                                \
    return launch_kv<DD, T>(q, k, v, kv_len, o, part, counters, B, Hq, Hkv, S, kv_row,    \
                            n_split, scale, st);
  switch (D) {
    ZGML_DECODE(16)
    ZGML_DECODE(32)
    ZGML_DECODE(64)
    ZGML_DECODE(128)
    default: return ZGML_ERR_HEAD_DIM;
  }
#undef ZGML_DECODE
}

ZGML_EXPORT int zgml_decode_attention_bf16(const float* q, const void* k, const void* v,
                                           const int* kv_len, float* o, float* part,
                                           unsigned int* counters, int B, int Hq, int Hkv, int S,
                                           int D, int kv_row, int n_split, float scale,
                                           void* stream) {
  return decode_kv<__nv_bfloat16>(q, k, v, kv_len, o, part, counters, B, Hq, Hkv, S, D, kv_row,
                                  n_split, scale, stream);
}

ZGML_EXPORT int zgml_decode_attention_f32(const float* q, const void* k, const void* v,
                                          const int* kv_len, float* o, float* part,
                                          unsigned int* counters, int B, int Hq, int Hkv, int S,
                                          int D, int kv_row, int n_split, float scale,
                                          void* stream) {
  return decode_kv<float>(q, k, v, kv_len, o, part, counters, B, Hq, Hkv, S, D, kv_row, n_split,
                          scale, stream);
}
