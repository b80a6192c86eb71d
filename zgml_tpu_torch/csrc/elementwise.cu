// K13 fused elementwise chain: out = step_n(... step_1(x) ...) in x's dtype
// (f32, bf16, f16 or int32), every step one unary op (neg, recip, sqr, sqrt,
// exp, log, abs, tanh, sigmoid, relu, silu, gelu in its tanh form, scale by
// p, add p) or one binary op (add, sub, mul, div, max2) with a side input,
// the chain value its left or its right operand. A side input is read in place through an index map (ops/
// elementwise.side_map): x's shape (index i), x's trailing dims such as a
// bias [d] on [M, d] (i mod inner), x's leading dims with trailing 1s such
// as [M, 1] (i / inner), or one value (index 0); any other broadcast is
// materialised by the wrapper.
//
// Replaces: zgml_tpu/ops/elementwise.py `_chain_impl` (pallas_call at line
// 104, inner `kernel` 91-102), which `ComputeGraph._emit_chain`
// (zgml_tpu/graph/graph.py:97-140) launches for every chain the fusion pass
// finds. The JAX kernel closes over the steps as Python callables, so every
// chain is its own compiled kernel; here the chain is a program of at most
// MAX_STEPS steps handed to one kernel by value (__grid_constant__), so one
// build serves every chain. The JAX kernel always calls fn(acc, side); this
// one honours the operand order of the graph (side_left), which is the
// graph's function (ROADMAP, Reference weak spots).
//
// Dtypes (the JAX kernel's: its accumulator and output are x's dtype, and
// the chain's value must stay in it, else the JAX kernel's store raises;
// ops/elementwise.chain_dtype raises the same): every step is the torch op
// on values of x's dtype, so at bf16 / f16 each elementary op's f32 result
// is rounded to the storage type (silu: the sigmoid, then the product; gelu:
// each of its products and sums), a scalar payload and gelu's constants
// rounded to it first (a Python scalar beside a bf16 array is a weak type in
// jnp). Side inputs come in x's dtype (the wrapper casts one of another
// dtype, as type promotion would). An int32 chain takes the ops that keep
// integers (neg, sqr, abs, relu, scale and add_scalar by an integer, add,
// sub, mul, max2), wrapping as torch and jnp do; any other op makes a float
// value, which the JAX kernel refuses to store.
//
// What bounds it on the H100: bytes. x and each side input are read once and
// out written once; a chain's few operations per element are far below the
// card's rate. At bf16 / f16 a step of a transcendental or a division
// (sigmoid, silu, gelu, div) is not: with half the bytes an element and 16
// values a thread (up to 128 registers, two blocks an SM) such a chain runs
// at about half its bytes bound (PERF.md, K13 row).
//
// What the design does about it: each thread takes 16-byte vectors of VEC
// consecutive elements (4 at f32 / int32, 8 at bf16 / f16), two at a time a
// grid stride apart (so every load of a warp is one coalesced 512-byte run),
// over a grid the SMs hold at once (the occupancy the library reports) that
// gives every thread the same number of vectors (ops/elementwise.
// chain_blocks). The two vectors of x and of the first PRELOAD side inputs
// are loaded before the step loop; the chain's 2 VEC values stay in
// registers (f32, or int32) through every step; the program is interpreted
// once for them, the switch on a step's op taken once for its lanes (the
// same for every thread, so warps do not diverge), and they go out in
// 16-byte stores. A side input that is not 16-byte aligned, or whose inner
// extent is not a multiple of VEC, is read one value a lane; where x or
// out is not 16-byte aligned, and for the elements past the last whole
// vector, the same steps run one element a thread. Indices are
// 32-bit where n plus the grid's threads stays below 2^31, else 64-bit.
// Ops that are exact in IEEE
// f32 (add, sub, mul, div, neg, abs, sqr, recip, sqrt, relu, max2, scale,
// add_scalar) use the round-to-nearest intrinsics, so nvcc contracts nothing
// into an FMA and each result is bit-equal to the plain torch version's;
// exp, log and tanh are the precise expf, logf, tanhf (no fast math,
// ops/build.py), as torch's own CUDA kernels call them. max2 and relu
// propagate NaN, as jnp.maximum and torch.maximum do.
#include "common.cuh"

namespace {

constexpr int MAX_STEPS = 16, MAX_SIDES = 8, THREADS = 256;
constexpr int PRELOAD = 2;    // side inputs loaded before the step loop (the rest at their step)

// the step codes of ops/elementwise.py OPCODES, in that order
enum ChainOp : int {
  OP_NEG = 0, OP_RECIP, OP_SQR, OP_SQRT, OP_EXP, OP_LOG, OP_ABS, OP_TANH, OP_SIGMOID, OP_RELU,
  OP_SILU, OP_GELU, OP_SCALE, OP_ADD_SCALAR,
  OP_ADD, OP_SUB, OP_MUL, OP_DIV, OP_MAX2,   // binary: from OP_ADD on
  OP_COUNT
};

// the chain's dtype (ops/elementwise.py DTYPE_CODES)
enum ChainType : int { TY_F32 = 0, TY_BF16, TY_F16, TY_I32, TY_COUNT };

// the side modes of ops/elementwise.py SIDE_MODES: element i of the chain
// reads side[i], side[i % inner], side[i / inner] or side[0]
enum SideMode : int { SIDE_SAME = 0, SIDE_SUFFIX, SIDE_ROWS, SIDE_SCALAR, SIDE_COUNT };

// ops/elementwise.py _Program mirrors these three structs
struct Step {
  int op;
  int side;        // binary: which side input
  int side_left;   // binary: 1 where the side input is the left operand
  float payload;   // scale / add_scalar of a float chain, rounded to its dtype
  int ipayload;    // the same of an int32 chain
};

struct Side {
  const void* ptr;   // x's dtype
  long long inner;   // suffix, rows: the extent of the map
  int mode;
  int vec;           // set by the launcher: a group's values come in 16-byte vectors
};

struct Program {
  Step steps[MAX_STEPS];
  Side sides[MAX_SIDES];
  int n_steps;
  int n_sides;
};
static_assert(sizeof(Program) == 520, "the layout of ops/elementwise.py _Program");

// The registers' type of a chain of storage type T: f32, or int32.
template <class T>
using val_t = std::conditional_t<std::is_same_v<T, int>, int, float>;
// elements of a 16-byte vector, and of a 32-bit word
template <class T>
constexpr int VEC = 16 / (int)sizeof(T);
template <class T>
constexpr int WORD = 4 / (int)sizeof(T);

// v rounded to T (round to nearest even) and back: the rounding after each
// op of a bf16 / f16 chain; nothing at f32 and int32.
template <class T>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else if constexpr (std::is_same_v<T, __half>) {
    return __half2float(__float2half_rn(v));
  } else {
    return v;
  }
}

// The WORD<T> values of a 32-bit word, and back (the values already of T).
template <class T>
__device__ __forceinline__ void unpack(uint32_t w, val_t<T>* v) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    v[0] = __uint_as_float(w << 16);
    v[1] = __uint_as_float(w & 0xffff0000u);
  } else if constexpr (std::is_same_v<T, __half>) {
    v[0] = __half2float(__ushort_as_half((unsigned short)(w & 0xffffu)));
    v[1] = __half2float(__ushort_as_half((unsigned short)(w >> 16)));
  } else if constexpr (std::is_same_v<T, int>) {
    v[0] = (int)w;
  } else {
    v[0] = __uint_as_float(w);
  }
}
template <class T>
__device__ __forceinline__ uint32_t pack(const val_t<T>* v) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[0])) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[1])) << 16);
  } else if constexpr (std::is_same_v<T, __half>) {
    return (uint32_t)__half_as_ushort(__float2half_rn(v[0])) |
           ((uint32_t)__half_as_ushort(__float2half_rn(v[1])) << 16);
  } else if constexpr (std::is_same_v<T, int>) {
    return (uint32_t)v[0];
  } else {
    return __float_as_uint(v[0]);
  }
}

// one element, and a 16-byte vector of VEC<T>, from global memory
template <class T, typename Idx>
__device__ __forceinline__ val_t<T> load1(const T* p, Idx i) {
  if constexpr (sizeof(T) == 2) {
    val_t<T> v[2];
    unpack<T>(__ldg(reinterpret_cast<const unsigned short*>(p) + i), v);
    return v[0];
  } else if constexpr (std::is_same_v<T, int>) {
    return __ldg(p + i);
  } else {
    return __ldg(p + i);
  }
}
template <class T>
__device__ __forceinline__ void load_vec(const T* p, val_t<T>* v) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  unpack<T>(q.x, v);
  unpack<T>(q.y, v + WORD<T>);
  unpack<T>(q.z, v + 2 * WORD<T>);
  unpack<T>(q.w, v + 3 * WORD<T>);
}
template <class T>
__device__ __forceinline__ void store_vec(T* p, const val_t<T>* v) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack<T>(v), pack<T>(v + WORD<T>),
                                            pack<T>(v + 2 * WORD<T>), pack<T>(v + 3 * WORD<T>));
}
template <class T, typename Idx>
__device__ __forceinline__ void store1(T* p, Idx i, val_t<T> v) {
  if constexpr (sizeof(T) == 2) {
    const val_t<T> two[2] = {v, v};
    reinterpret_cast<unsigned short*>(p)[i] = (unsigned short)(pack<T>(two) & 0xffffu);
  } else {
    p[i] = v;
  }
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ float sigmoid_f(float a) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-a)));
}

// JAX's jax.nn.gelu(approximate=True):
// x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x^3)))), x^3 = x * (x * x),
// every op rounded to T, its constants too
template <class T>
__device__ __forceinline__ float gelu_tanh(float a) {
  const float c3 = rnd<T>(0.044715f), c2 = rnd<T>(0.7978845608028654f);
  const float x3 = rnd<T>(__fmul_rn(a, rnd<T>(__fmul_rn(a, a))));
  const float inner =
      rnd<T>(__fmul_rn(c2, rnd<T>(__fadd_rn(a, rnd<T>(__fmul_rn(c3, x3))))));
  return rnd<T>(
      __fmul_rn(a, rnd<T>(__fmul_rn(0.5f, rnd<T>(__fadd_rn(1.0f, rnd<T>(tanhf(inner))))))));
}

// int32 ops wrap as torch's and jnp's do
__device__ __forceinline__ int wrap_add(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
__device__ __forceinline__ int wrap_sub(int a, int b) { return (int)((unsigned)a - (unsigned)b); }
__device__ __forceinline__ int wrap_mul(int a, int b) { return (int)((unsigned)a * (unsigned)b); }

// L lanes of a thread: L / VEC vectors of VEC consecutive elements, vector h
// from element at[h] (a multiple of VEC) on; or (L = 1) element at[0].
template <class T, int L>
constexpr int n_at = L >= VEC<T> ? L / VEC<T> : 1;

// The side's values for the lanes at `at`.
template <class T, int L, typename Idx>
__device__ __forceinline__ void load_side(const Side& s, const Idx (&at)[n_at<T, L>],
                                          val_t<T> (&v)[L]) {
  const T* ptr = static_cast<const T*>(s.ptr);
  if (s.mode == SIDE_SCALAR) {
    const val_t<T> a = load1(ptr, 0);
#pragma unroll
    for (int e = 0; e < L; ++e) v[e] = a;
    return;
  }
  const Idx inner = (Idx)s.inner;
  if constexpr (L >= VEC<T>) {
    if (s.vec) {                    // a vector a vector, or one value of a row
#pragma unroll
      for (int h = 0; h < L / VEC<T>; ++h) {
        const Idx i = at[h];
        if (s.mode == SIDE_ROWS) {
          const val_t<T> a = load1(ptr, i / inner);
#pragma unroll
          for (int e = 0; e < VEC<T>; ++e) v[VEC<T> * h + e] = a;
        } else {
          load_vec(ptr + (s.mode == SIDE_SAME ? i : i % inner), v + VEC<T> * h);
        }
      }
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < L; ++e) {
    const Idx i = at[e / VEC<T>] + e % VEC<T>;
    const Idx j = s.mode == SIDE_SAME ? i : s.mode == SIDE_SUFFIX ? i % inner : i / inner;
    v[e] = load1(ptr, j);
  }
}

template <int L, typename V, typename F>
__device__ __forceinline__ void each(V (&acc)[L], F f) {
#pragma unroll
  for (int e = 0; e < L; ++e) acc[e] = f(acc[e], e);
}

// One step of a float chain of storage type T on L lanes (sv: the side's
// values of a binary step).
template <class T, int L>
__device__ __forceinline__ void float_step(const Step& st, float (&acc)[L], const float (&sv)[L]) {
  const bool left = st.side_left;
  const float pay = st.payload;
  switch (st.op) {
    case OP_NEG: each(acc, [](float a, int) { return -a; }); break;
    case OP_RECIP: each(acc, [](float a, int) { return rnd<T>(__fdiv_rn(1.0f, a)); }); break;
    case OP_SQR: each(acc, [](float a, int) { return rnd<T>(__fmul_rn(a, a)); }); break;
    case OP_SQRT: each(acc, [](float a, int) { return rnd<T>(__fsqrt_rn(a)); }); break;
    case OP_EXP: each(acc, [](float a, int) { return rnd<T>(expf(a)); }); break;
    case OP_LOG: each(acc, [](float a, int) { return rnd<T>(logf(a)); }); break;
    case OP_ABS: each(acc, [](float a, int) { return fabsf(a); }); break;
    case OP_TANH: each(acc, [](float a, int) { return rnd<T>(tanhf(a)); }); break;
    case OP_SIGMOID: each(acc, [](float a, int) { return rnd<T>(sigmoid_f(a)); }); break;
    case OP_RELU: each(acc, [](float a, int) { return nan_max(a, 0.f); }); break;
    case OP_SILU:
      each(acc, [](float a, int) { return rnd<T>(__fmul_rn(a, rnd<T>(sigmoid_f(a)))); });
      break;
    case OP_GELU: each(acc, [](float a, int) { return gelu_tanh<T>(a); }); break;
    case OP_SCALE: each(acc, [pay](float a, int) { return rnd<T>(__fmul_rn(a, pay)); }); break;
    case OP_ADD_SCALAR:
      each(acc, [pay](float a, int) { return rnd<T>(__fadd_rn(a, pay)); });
      break;
    case OP_ADD:
      each(acc, [&](float a, int e) {
        return rnd<T>(left ? __fadd_rn(sv[e], a) : __fadd_rn(a, sv[e]));
      });
      break;
    case OP_SUB:
      each(acc, [&](float a, int e) {
        return rnd<T>(left ? __fsub_rn(sv[e], a) : __fsub_rn(a, sv[e]));
      });
      break;
    case OP_MUL:
      each(acc, [&](float a, int e) {
        return rnd<T>(left ? __fmul_rn(sv[e], a) : __fmul_rn(a, sv[e]));
      });
      break;
    case OP_DIV:
      each(acc, [&](float a, int e) {
        return rnd<T>(left ? __fdiv_rn(sv[e], a) : __fdiv_rn(a, sv[e]));
      });
      break;
    default:   // OP_MAX2
      each(acc, [&](float a, int e) { return left ? nan_max(sv[e], a) : nan_max(a, sv[e]); });
      break;
  }
}

// One step of an int32 chain (the launcher admits only the ops that keep
// integers).
template <int L>
__device__ __forceinline__ void int_step(const Step& st, int (&acc)[L], const int (&sv)[L]) {
  const bool left = st.side_left;
  const int pay = st.ipayload;
  switch (st.op) {
    case OP_NEG: each(acc, [](int a, int) { return wrap_sub(0, a); }); break;
    case OP_SQR: each(acc, [](int a, int) { return wrap_mul(a, a); }); break;
    case OP_ABS: each(acc, [](int a, int) { return a < 0 ? wrap_sub(0, a) : a; }); break;
    case OP_RELU: each(acc, [](int a, int) { return a > 0 ? a : 0; }); break;
    case OP_SCALE: each(acc, [pay](int a, int) { return wrap_mul(a, pay); }); break;
    case OP_ADD_SCALAR: each(acc, [pay](int a, int) { return wrap_add(a, pay); }); break;
    case OP_ADD: each(acc, [&](int a, int e) { return wrap_add(a, sv[e]); }); break;
    case OP_SUB:
      each(acc, [&](int a, int e) { return left ? wrap_sub(sv[e], a) : wrap_sub(a, sv[e]); });
      break;
    case OP_MUL: each(acc, [&](int a, int e) { return wrap_mul(a, sv[e]); }); break;
    default:   // OP_MAX2
      each(acc, [&](int a, int e) { return a > sv[e] ? a : sv[e]; });
      break;
  }
}

// Every step of the program on L lanes; pre[k] holds side k's values for
// k < PRE, the other sides are loaded at their step.
template <class T, int L, int PRE, typename Idx>
__device__ __forceinline__ void run_steps(const Program& p, val_t<T> (&acc)[L],
                                          const val_t<T> (&pre)[PRE > 0 ? PRE : 1][L],
                                          const Idx (&at)[n_at<T, L>]) {
  for (int s = 0; s < p.n_steps; ++s) {
    const Step st = p.steps[s];
    val_t<T> sv[L];
    if (st.op >= OP_ADD) {
      if (PRE > 0 && st.side == 0) {
#pragma unroll
        for (int e = 0; e < L; ++e) sv[e] = pre[0][e];
      } else if (PRE > 1 && st.side == 1) {
#pragma unroll
        for (int e = 0; e < L; ++e) sv[e] = pre[PRE > 1 ? 1 : 0][e];
      } else {
        load_side<T, L>(p.sides[st.side], at, sv);
      }
    }
    if constexpr (std::is_same_v<T, int>) {
      int_step<L>(st, acc, sv);
    } else {
      float_step<T, L>(st, acc, sv);
    }
  }
}

// L lanes at `at` through the chain: their x and first PRE side inputs
// loaded, the steps, the result stored.
template <class T, int L, int PRE, typename Idx>
__device__ __forceinline__ void run_lanes(const T* __restrict__ x, T* __restrict__ out,
                                          const Program& prog, const Idx (&at)[n_at<T, L>]) {
  val_t<T> acc[L], pre[PRE > 0 ? PRE : 1][L];
  if constexpr (L >= VEC<T>) {
#pragma unroll
    for (int h = 0; h < L / VEC<T>; ++h) load_vec(x + at[h], acc + VEC<T> * h);
  } else {
    acc[0] = load1(x, at[0]);
  }
#pragma unroll
  for (int k = 0; k < PRE; ++k) load_side<T, L>(prog.sides[k], at, pre[k]);
  run_steps<T, L, PRE>(prog, acc, pre, at);
  if constexpr (L >= VEC<T>) {
#pragma unroll
    for (int h = 0; h < L / VEC<T>; ++h) store_vec(out + at[h], acc + VEC<T> * h);
  } else {
    store1(out, at[0], acc[0]);
  }
}

// grouped: x and out are 16-byte aligned, so the whole vectors take the
// vector loop, two a thread at a time a grid stride apart (each warp's load
// one coalesced run), the odd one alone; the elements past the last whole
// vector (all of them where not grouped) one a thread
// (min 2 blocks an SM: given the block size alone, ptxas capped the 64-bit
// instantiation at 64 registers and spilled)
template <class T, int PRE, typename Idx>
__global__ void __launch_bounds__(THREADS, 2)
chain_kernel(const T* __restrict__ x, T* __restrict__ out, Idx n, int grouped,
             const __grid_constant__ Program prog) {
  constexpr int V = VEC<T>;
  const Idx stride = (Idx)gridDim.x * blockDim.x;
  const Idx tid = (Idx)blockIdx.x * blockDim.x + threadIdx.x;
  const Idx nvec = grouped ? n / V : 0;
  Idx v = tid;
  for (; v + stride < nvec; v += 2 * stride) {
    const Idx at[2] = {v * V, (v + stride) * V};
    run_lanes<T, 2 * V, PRE>(x, out, prog, at);
  }
  if (v < nvec) {
    const Idx at[1] = {v * V};
    run_lanes<T, V, PRE>(x, out, prog, at);
  }
  for (Idx i = nvec * V + tid; i < n; i += stride) {
    const Idx at[1] = {i};
    run_lanes<T, 1, PRE>(x, out, prog, at);
  }
}

template <class T, typename Idx>
int occupancy(int pre, int* n) {
  switch (pre) {
    case 0: return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, chain_kernel<T, 0, Idx>,
                                                                     THREADS, 0);
    case 1: return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, chain_kernel<T, 1, Idx>,
                                                                     THREADS, 0);
    default: return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, chain_kernel<T, 2, Idx>,
                                                                       THREADS, 0);
  }
}

template <class T, typename Idx>
void launch(const T* x, T* out, Idx n, int grouped, const Program& prog, int blocks,
            cudaStream_t st) {
  switch (prog.n_sides < PRELOAD ? prog.n_sides : PRELOAD) {
    case 0: chain_kernel<T, 0, Idx><<<blocks, THREADS, 0, st>>>(x, out, n, grouped, prog); break;
    case 1: chain_kernel<T, 1, Idx><<<blocks, THREADS, 0, st>>>(x, out, n, grouped, prog); break;
    default:
      chain_kernel<T, 2, Idx><<<blocks, THREADS, 0, st>>>(x, out, n, grouped, prog);
      break;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Whether an int32 chain takes op (the ops whose value stays an integer).
bool int_op(const Step& st) {
  switch (st.op) {
    case OP_NEG: case OP_SQR: case OP_ABS: case OP_RELU: case OP_SCALE: case OP_ADD_SCALAR:
    case OP_ADD: case OP_SUB: case OP_MUL: case OP_MAX2:
      return true;
    default:
      return false;
  }
}

template <class T>
int run(const void* x, void* out, long long n, Program& prog, int blocks, cudaStream_t st) {
  constexpr int V = VEC<T>;
  for (int s = 0; s < prog.n_steps; ++s)
    if (std::is_same_v<T, int> && !int_op(prog.steps[s])) return ZGML_ERR_SHAPE;
  for (int k = 0; k < prog.n_sides; ++k) {
    Side& sd = prog.sides[k];
    switch (sd.mode) {
      case SIDE_SAME: sd.vec = aligned16(sd.ptr); break;
      case SIDE_SUFFIX: sd.vec = aligned16(sd.ptr) && sd.inner % V == 0; break;
      case SIDE_ROWS: sd.vec = sd.inner % V == 0; break;
      default: sd.vec = 1; break;
    }
  }
  const int grouped = aligned16(x) && aligned16(out);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  // 32-bit indices where the element loop's i + stride stays below 2^31
  // (ops/elementwise.index_wide)
  if (n + (long long)blocks * THREADS < (1LL << 31))
    launch<T, int>(xt, ot, (int)n, grouped, prog, blocks, st);
  else
    launch<T, long long>(xt, ot, n, grouped, prog, blocks, st);
  return (int)cudaGetLastError();
}

template <class T>
int blocks_per_sm(int pre, int wide, int* n) {
  return wide ? occupancy<T, long long>(pre, n) : occupancy<T, int>(pre, n);
}

}  // namespace

// Blocks of the chain kernel an SM holds, for the instantiation a launch of
// dtype `dtype` (ChainType) with min(n_sides, PRELOAD) = pre side inputs
// loaded up front takes (wide: 64-bit indices, see zgml_fused_chain).
ZGML_EXPORT int zgml_fused_chain_blocks_per_sm(int dtype, int pre, int wide, int* n) {
  if (pre < 0 || pre > PRELOAD) return ZGML_ERR_SHAPE;
  switch (dtype) {
    case TY_F32: return blocks_per_sm<float>(pre, wide, n);
    case TY_BF16: return blocks_per_sm<__nv_bfloat16>(pre, wide, n);
    case TY_F16: return blocks_per_sm<__half>(pre, wide, n);
    case TY_I32: return blocks_per_sm<int>(pre, wide, n);
    default: return ZGML_ERR_SHAPE;
  }
}

// x, out [n] (contiguous) of dtype `dtype` (ChainType: f32, bf16, f16 or
// int32); `program` a Program (ops/elementwise.py _Program): the steps, and
// each side input's pointer (contiguous, x's dtype), map mode and inner
// extent; `blocks` the grid (ops/elementwise.py: at most what the SMs hold
// at once); on `stream`. An int32 chain takes only the ops that keep
// integers.
ZGML_EXPORT int zgml_fused_chain(int dtype, const void* x, void* out, long long n,
                                 const void* program, int blocks, void* stream) {
  Program prog = *static_cast<const Program*>(program);
  if (n <= 0 || blocks <= 0 || prog.n_steps <= 0 || prog.n_steps > MAX_STEPS ||
      prog.n_sides < 0 || prog.n_sides > MAX_SIDES)
    return ZGML_ERR_SHAPE;
  for (int s = 0; s < prog.n_steps; ++s) {
    const Step& st = prog.steps[s];
    if (st.op < 0 || st.op >= OP_COUNT) return ZGML_ERR_SHAPE;
    if (st.op >= OP_ADD && (st.side < 0 || st.side >= prog.n_sides)) return ZGML_ERR_SHAPE;
  }
  for (int k = 0; k < prog.n_sides; ++k) {
    const Side& sd = prog.sides[k];
    if (!sd.ptr || sd.mode < 0 || sd.mode >= SIDE_COUNT) return ZGML_ERR_SHAPE;
    const bool mapped = sd.mode == SIDE_SUFFIX || sd.mode == SIDE_ROWS;
    if (mapped && (sd.inner <= 0 || n % sd.inner)) return ZGML_ERR_SHAPE;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case TY_F32: return run<float>(x, out, n, prog, blocks, st);
    case TY_BF16: return run<__nv_bfloat16>(x, out, n, prog, blocks, st);
    case TY_F16: return run<__half>(x, out, n, prog, blocks, st);
    case TY_I32: return run<int>(x, out, n, prog, blocks, st);
    default: return ZGML_ERR_SHAPE;
  }
}
