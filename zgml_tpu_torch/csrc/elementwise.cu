// K13 fused elementwise chain: out = step_n(... step_1(x) ...), f32, every
// step one unary op (neg, recip, sqr, sqrt, exp, log, abs, tanh, sigmoid,
// relu, silu, gelu in its tanh form, scale by p, add p) or one binary op (add,
// sub, mul, div, max2) with a side input, the chain value its left or its
// right operand. A side input is read in place through an index map (ops/
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
// What bounds it on the H100: bytes. x and each side input are read once and
// out written once; a chain's few operations per element are far below the
// card's rate.
//
// What the design does about it: each thread takes 16-byte vectors of 4
// consecutive elements, two at a time a grid stride apart (so every load of
// a warp is one coalesced 512-byte run), over a grid the SMs hold at once
// (the occupancy the library reports) that gives every thread the same
// number of vectors (ops/elementwise.chain_blocks). The two vectors of x and
// of the first PRELOAD side inputs are loaded before the step loop; the
// chain's 8 values stay in registers through every step; the program is
// interpreted once for them, the switch on a step's op taken once for its 8
// lanes (the same for every thread, so warps do not diverge), and they go
// out in 16-byte stores. A side input that is not 16-byte aligned, or whose
// inner extent is not a multiple of 4, is read one value a lane; where x or
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
constexpr int VEC = 4;        // elements of a 16-byte vector
constexpr int PRELOAD = 2;    // side inputs loaded before the step loop (the rest at their step)

// the step codes of ops/elementwise.py OPCODES, in that order
enum ChainOp : int {
  OP_NEG = 0, OP_RECIP, OP_SQR, OP_SQRT, OP_EXP, OP_LOG, OP_ABS, OP_TANH, OP_SIGMOID, OP_RELU,
  OP_SILU, OP_GELU, OP_SCALE, OP_ADD_SCALAR,
  OP_ADD, OP_SUB, OP_MUL, OP_DIV, OP_MAX2,   // binary: from OP_ADD on
  OP_COUNT
};

// the side modes of ops/elementwise.py SIDE_MODES: element i of the chain
// reads side[i], side[i % inner], side[i / inner] or side[0]
enum SideMode : int { SIDE_SAME = 0, SIDE_SUFFIX, SIDE_ROWS, SIDE_SCALAR, SIDE_COUNT };

// ops/elementwise.py _Program mirrors these three structs
struct Step {
  int op;
  int side;        // binary: which side input
  int side_left;   // binary: 1 where the side input is the left operand
  float payload;   // scale / add_scalar
};

struct Side {
  const float* ptr;
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
static_assert(sizeof(Program) == 456, "the layout of ops/elementwise.py _Program");

__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ float sigmoid_f(float a) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-a)));
}

// JAX's jax.nn.gelu(approximate=True):
// x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x^3)))), x^3 = x * (x * x)
__device__ __forceinline__ float gelu_tanh(float a) {
  const float x3 = __fmul_rn(a, __fmul_rn(a, a));
  const float inner = __fmul_rn(0.7978845608028654f, __fadd_rn(a, __fmul_rn(0.044715f, x3)));
  return __fmul_rn(a, __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(inner))));
}

__device__ __forceinline__ void put4(float* v, const float4& q) {
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}

// L lanes of a thread: L / VEC vectors of VEC consecutive elements, vector h
// from element at[h] (a multiple of VEC) on; or (L = 1) element at[0].
template <int L>
constexpr int n_at = L >= VEC ? L / VEC : 1;

// The side's values for the lanes at `at`.
template <int L, typename Idx>
__device__ __forceinline__ void load_side(const Side& s, const Idx (&at)[n_at<L>],
                                          float (&v)[L]) {
  if (s.mode == SIDE_SCALAR) {
    const float a = __ldg(s.ptr);
#pragma unroll
    for (int e = 0; e < L; ++e) v[e] = a;
    return;
  }
  const Idx inner = (Idx)s.inner;
  if constexpr (L >= VEC) {
    if (s.vec) {                    // a vector a vector, or one value of a row
#pragma unroll
      for (int h = 0; h < L / VEC; ++h) {
        const Idx i = at[h];
        if (s.mode == SIDE_ROWS) {
          const float a = __ldg(s.ptr + i / inner);
          v[4 * h] = v[4 * h + 1] = v[4 * h + 2] = v[4 * h + 3] = a;
        } else {
          const Idx j = s.mode == SIDE_SAME ? i : i % inner;
          put4(v + 4 * h, __ldg(reinterpret_cast<const float4*>(s.ptr + j)));
        }
      }
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < L; ++e) {
    const Idx i = at[e / VEC] + e % VEC;
    const Idx j = s.mode == SIDE_SAME ? i : s.mode == SIDE_SUFFIX ? i % inner : i / inner;
    v[e] = __ldg(s.ptr + j);
  }
}

template <int L, typename F>
__device__ __forceinline__ void each(float (&acc)[L], F f) {
#pragma unroll
  for (int e = 0; e < L; ++e) acc[e] = f(acc[e], e);
}

// Every step of the program on L lanes; pre[k] holds side k's values for
// k < PRE, the other sides are loaded at their step.
template <int L, int PRE, typename Idx>
__device__ __forceinline__ void run_steps(const Program& p, float (&acc)[L],
                                          const float (&pre)[PRE > 0 ? PRE : 1][L],
                                          const Idx (&at)[n_at<L>]) {
  for (int s = 0; s < p.n_steps; ++s) {
    const Step st = p.steps[s];
    float sv[L];
    if (st.op >= OP_ADD) {
      if (PRE > 0 && st.side == 0) {
#pragma unroll
        for (int e = 0; e < L; ++e) sv[e] = pre[0][e];
      } else if (PRE > 1 && st.side == 1) {
#pragma unroll
        for (int e = 0; e < L; ++e) sv[e] = pre[PRE > 1 ? 1 : 0][e];
      } else {
        load_side<L>(p.sides[st.side], at, sv);
      }
    }
    const bool left = st.side_left;
    const float pay = st.payload;
    switch (st.op) {
      case OP_NEG: each(acc, [](float a, int) { return -a; }); break;
      case OP_RECIP: each(acc, [](float a, int) { return __fdiv_rn(1.0f, a); }); break;
      case OP_SQR: each(acc, [](float a, int) { return __fmul_rn(a, a); }); break;
      case OP_SQRT: each(acc, [](float a, int) { return __fsqrt_rn(a); }); break;
      case OP_EXP: each(acc, [](float a, int) { return expf(a); }); break;
      case OP_LOG: each(acc, [](float a, int) { return logf(a); }); break;
      case OP_ABS: each(acc, [](float a, int) { return fabsf(a); }); break;
      case OP_TANH: each(acc, [](float a, int) { return tanhf(a); }); break;
      case OP_SIGMOID: each(acc, [](float a, int) { return sigmoid_f(a); }); break;
      case OP_RELU: each(acc, [](float a, int) { return nan_max(a, 0.f); }); break;
      case OP_SILU: each(acc, [](float a, int) { return __fmul_rn(a, sigmoid_f(a)); }); break;
      case OP_GELU: each(acc, [](float a, int) { return gelu_tanh(a); }); break;
      case OP_SCALE: each(acc, [pay](float a, int) { return __fmul_rn(a, pay); }); break;
      case OP_ADD_SCALAR: each(acc, [pay](float a, int) { return __fadd_rn(a, pay); }); break;
      case OP_ADD:
        each(acc, [&](float a, int e) { return left ? __fadd_rn(sv[e], a) : __fadd_rn(a, sv[e]); });
        break;
      case OP_SUB:
        each(acc, [&](float a, int e) { return left ? __fsub_rn(sv[e], a) : __fsub_rn(a, sv[e]); });
        break;
      case OP_MUL:
        each(acc, [&](float a, int e) { return left ? __fmul_rn(sv[e], a) : __fmul_rn(a, sv[e]); });
        break;
      case OP_DIV:
        each(acc, [&](float a, int e) { return left ? __fdiv_rn(sv[e], a) : __fdiv_rn(a, sv[e]); });
        break;
      default:   // OP_MAX2
        each(acc, [&](float a, int e) { return left ? nan_max(sv[e], a) : nan_max(a, sv[e]); });
        break;
    }
  }
}

// L lanes at `at` through the chain: their x and first PRE side inputs
// loaded, the steps, the result stored.
template <int L, int PRE, typename Idx>
__device__ __forceinline__ void run_lanes(const float* __restrict__ x, float* __restrict__ out,
                                          const Program& prog, const Idx (&at)[n_at<L>]) {
  float acc[L], pre[PRE > 0 ? PRE : 1][L];
  if constexpr (L >= VEC) {
#pragma unroll
    for (int h = 0; h < L / VEC; ++h)
      put4(acc + 4 * h, __ldg(reinterpret_cast<const float4*>(x + at[h])));
  } else {
    acc[0] = __ldg(x + at[0]);
  }
#pragma unroll
  for (int k = 0; k < PRE; ++k) load_side<L>(prog.sides[k], at, pre[k]);
  run_steps<L, PRE>(prog, acc, pre, at);
  if constexpr (L >= VEC) {
#pragma unroll
    for (int h = 0; h < L / VEC; ++h)
      *reinterpret_cast<float4*>(out + at[h]) =
          make_float4(acc[4 * h], acc[4 * h + 1], acc[4 * h + 2], acc[4 * h + 3]);
  } else {
    out[at[0]] = acc[0];
  }
}

// grouped: x and out are 16-byte aligned, so the whole vectors take the
// vector loop, two a thread at a time a grid stride apart (each warp's load
// one coalesced run), the odd one alone; the elements past the last whole
// vector (all of them where not grouped) one a thread
// (min 2 blocks an SM: given the block size alone, ptxas capped the 64-bit
// instantiation at 64 registers and spilled)
template <int PRE, typename Idx>
__global__ void __launch_bounds__(THREADS, 2)
chain_kernel(const float* __restrict__ x, float* __restrict__ out, Idx n, int grouped,
             const __grid_constant__ Program prog) {
  const Idx stride = (Idx)gridDim.x * blockDim.x;
  const Idx tid = (Idx)blockIdx.x * blockDim.x + threadIdx.x;
  const Idx nvec = grouped ? n / VEC : 0;
  Idx v = tid;
  for (; v + stride < nvec; v += 2 * stride) {
    const Idx at[2] = {v * VEC, (v + stride) * VEC};
    run_lanes<2 * VEC, PRE>(x, out, prog, at);
  }
  if (v < nvec) {
    const Idx at[1] = {v * VEC};
    run_lanes<VEC, PRE>(x, out, prog, at);
  }
  for (Idx i = nvec * VEC + tid; i < n; i += stride) {
    const Idx at[1] = {i};
    run_lanes<1, PRE>(x, out, prog, at);
  }
}

template <typename Idx>
int occupancy(int pre, int* n) {
  switch (pre) {
    case 0: return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, chain_kernel<0, Idx>,
                                                                     THREADS, 0);
    case 1: return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, chain_kernel<1, Idx>,
                                                                     THREADS, 0);
    default: return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, chain_kernel<2, Idx>,
                                                                       THREADS, 0);
  }
}

template <typename Idx>
void launch(const float* x, float* out, Idx n, int grouped, const Program& prog, int blocks,
            cudaStream_t st) {
  switch (prog.n_sides < PRELOAD ? prog.n_sides : PRELOAD) {
    case 0: chain_kernel<0, Idx><<<blocks, THREADS, 0, st>>>(x, out, n, grouped, prog); break;
    case 1: chain_kernel<1, Idx><<<blocks, THREADS, 0, st>>>(x, out, n, grouped, prog); break;
    default: chain_kernel<2, Idx><<<blocks, THREADS, 0, st>>>(x, out, n, grouped, prog); break;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// Blocks of the chain kernel an SM holds, for the instantiation a launch
// with min(n_sides, PRELOAD) = pre side inputs loaded up front takes (wide:
// 64-bit indices, see zgml_fused_chain).
ZGML_EXPORT int zgml_fused_chain_blocks_per_sm(int pre, int wide, int* n) {
  if (pre < 0 || pre > PRELOAD) return ZGML_ERR_SHAPE;
  return wide ? occupancy<long long>(pre, n) : occupancy<int>(pre, n);
}

// x, out f32 [n] (contiguous); `program` a Program (ops/elementwise.py
// _Program): the steps, and each side input's pointer (contiguous f32), map
// mode and inner extent; `blocks` the grid (ops/elementwise.py: at most
// what the SMs hold at once); on `stream`.
ZGML_EXPORT int zgml_fused_chain(const float* x, float* out, long long n, const void* program,
                                 int blocks, void* stream) {
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
    Side& sd = prog.sides[k];
    if (!sd.ptr || sd.mode < 0 || sd.mode >= SIDE_COUNT) return ZGML_ERR_SHAPE;
    const bool mapped = sd.mode == SIDE_SUFFIX || sd.mode == SIDE_ROWS;
    if (mapped && (sd.inner <= 0 || n % sd.inner)) return ZGML_ERR_SHAPE;
    switch (sd.mode) {
      case SIDE_SAME: sd.vec = aligned16(sd.ptr); break;
      case SIDE_SUFFIX: sd.vec = aligned16(sd.ptr) && sd.inner % 4 == 0; break;
      case SIDE_ROWS: sd.vec = sd.inner % 4 == 0; break;
      default: sd.vec = 1; break;
    }
  }
  const int grouped = aligned16(x) && aligned16(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 32-bit indices where the element loop's i + stride stays below 2^31
  // (ops/elementwise.index_wide)
  if (n + (long long)blocks * THREADS < (1LL << 31))
    launch<int>(x, out, (int)n, grouped, prog, blocks, st);
  else
    launch<long long>(x, out, n, grouped, prog, blocks, st);
  return (int)cudaGetLastError();
}
