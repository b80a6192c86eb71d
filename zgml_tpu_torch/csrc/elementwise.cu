// K13 fused elementwise chain: out = step_n(... step_1(x) ...), f32, every
// step one unary op (neg, recip, sqr, sqrt, exp, log, abs, tanh, sigmoid,
// relu, silu, gelu in its tanh form, scale by p, add p) or one binary op (add,
// sub, mul, div, max2) with a side input of x's shape, the chain value its
// left or its right operand.
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
// What the design does about it: one element per thread in a grid-stride
// loop (neighbouring threads on neighbouring addresses), the chain's value
// kept in a register through every step; the switch on the step's op is the
// same for every thread, so warps do not diverge. Ops that are exact in IEEE
// f32 (add, sub, mul, div, neg, abs, sqr, recip, sqrt, relu, max2, scale,
// add_scalar) use the round-to-nearest intrinsics, so nvcc contracts nothing
// into an FMA and each result is bit-equal to the plain torch version's;
// exp, log and tanh are the precise expf, logf, tanhf (no fast math,
// ops/build.py), as torch's own CUDA kernels call them. max2 and relu
// propagate NaN, as jnp.maximum and torch.maximum do.
#include "common.cuh"

namespace {

constexpr int MAX_STEPS = 16, MAX_SIDES = 8, THREADS = 256, BLOCKS_PER_SM = 16;

// the step codes of ops/elementwise.py OPCODES, in that order
enum ChainOp : int {
  OP_NEG = 0, OP_RECIP, OP_SQR, OP_SQRT, OP_EXP, OP_LOG, OP_ABS, OP_TANH, OP_SIGMOID, OP_RELU,
  OP_SILU, OP_GELU, OP_SCALE, OP_ADD_SCALAR,
  OP_ADD, OP_SUB, OP_MUL, OP_DIV, OP_MAX2,   // binary: from OP_ADD on
  OP_COUNT
};

struct Step {
  int op;
  int side;        // binary: which side input
  int side_left;   // binary: 1 where the side input is the left operand
  float payload;   // scale / add_scalar
};

struct Program {
  Step steps[MAX_STEPS];
  const float* sides[MAX_SIDES];
  int n_steps;
};

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

__global__ void __launch_bounds__(THREADS)
chain_kernel(const float* __restrict__ x, float* __restrict__ out, long long n,
             const __grid_constant__ Program prog) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    float acc = __ldg(x + i);
    for (int s = 0; s < prog.n_steps; ++s) {
      const Step& st = prog.steps[s];
      float l = acc, r = 0.f;
      if (st.op >= OP_ADD) {
        const float side = __ldg(prog.sides[st.side] + i);
        l = st.side_left ? side : acc;
        r = st.side_left ? acc : side;
      }
      switch (st.op) {
        case OP_NEG: acc = -acc; break;
        case OP_RECIP: acc = __fdiv_rn(1.0f, acc); break;
        case OP_SQR: acc = __fmul_rn(acc, acc); break;
        case OP_SQRT: acc = __fsqrt_rn(acc); break;
        case OP_EXP: acc = expf(acc); break;
        case OP_LOG: acc = logf(acc); break;
        case OP_ABS: acc = fabsf(acc); break;
        case OP_TANH: acc = tanhf(acc); break;
        case OP_SIGMOID: acc = sigmoid_f(acc); break;
        case OP_RELU: acc = nan_max(acc, 0.f); break;
        case OP_SILU: acc = __fmul_rn(acc, sigmoid_f(acc)); break;
        case OP_GELU: acc = gelu_tanh(acc); break;
        case OP_SCALE: acc = __fmul_rn(acc, st.payload); break;
        case OP_ADD_SCALAR: acc = __fadd_rn(acc, st.payload); break;
        case OP_ADD: acc = __fadd_rn(l, r); break;
        case OP_SUB: acc = __fsub_rn(l, r); break;
        case OP_MUL: acc = __fmul_rn(l, r); break;
        case OP_DIV: acc = __fdiv_rn(l, r); break;
        default: acc = nan_max(l, r); break;   // OP_MAX2
      }
    }
    out[i] = acc;
  }
}

}  // namespace

// x, out f32 [n] (contiguous); n_steps steps, step s = (ops[s], payloads[s],
// side_idx[s], side_left[s]); sides: n_sides pointers to f32 [n] (contiguous);
// on `stream`.
ZGML_EXPORT int zgml_fused_chain(const float* x, float* out, long long n, int n_steps,
                                 const int* ops, const float* payloads, const int* side_idx,
                                 const int* side_left, const void* const* sides, int n_sides,
                                 void* stream) {
  if (n <= 0 || n_steps <= 0 || n_steps > MAX_STEPS || n_sides < 0 || n_sides > MAX_SIDES)
    return ZGML_ERR_SHAPE;
  Program prog{};
  prog.n_steps = n_steps;
  for (int s = 0; s < n_sides; ++s) prog.sides[s] = static_cast<const float*>(sides[s]);
  for (int s = 0; s < n_steps; ++s) {
    if (ops[s] < 0 || ops[s] >= OP_COUNT) return ZGML_ERR_SHAPE;
    if (ops[s] >= OP_ADD && (side_idx[s] < 0 || side_idx[s] >= n_sides)) return ZGML_ERR_SHAPE;
    prog.steps[s] = Step{ops[s], side_idx[s], side_left[s], payloads[s]};
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (n + THREADS - 1) / THREADS;
  const long long cap = (long long)(sms > 0 ? sms : 132) * BLOCKS_PER_SM;
  const int blocks = (int)(want < cap ? want : cap);
  chain_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(x, out, n, prog);
  return (int)cudaGetLastError();
}
