"""K13: the fused elementwise chain, its plain version, and its autograd Function.

Counterpart of zgml_tpu/ops/elementwise.py (`fused_chain`, `_chain_impl`,
`_chain_vjp`). A chain is data, not callables: a sequence of ``Step``s, each
an op name of OPCODES, an f32 payload (``scale``, ``add_scalar``) and, for a
binary op, the side input it takes and whether that side input is the left
operand (``side_left``: the chain value is then the right one). Side inputs
broadcast to x's shape, as `_chain_jnp` broadcasts them.

  side_map          how K13 reads a side input in place (x's shape, its
                    trailing dims, its leading dims, one value), or that it
                    must be materialised at x's shape first
  chain_dtype       the dtype of the chain's value; check_dtype raises where
                    it is not x's, as the JAX kernel's store does
  fused_chain_cuda  launch csrc/elementwise.cu (f32, bf16, f16, int32)
  fused_chain_ref   the plain composition of the same steps in torch
  FusedChain        K13 (or the plain version) forward; the backward recomputes
                    the plain composition under autograd, as `_chain_bwd` does
                    (elementwise.py:60-63), in the chain's dtype

The ops are the graph tier's elementwise lowering rules (graph/lower.py calls
``unary`` and ``binary`` here), so a chain fused or not computes the same
function. Each step is the torch op on the chain's dtype, as each JAX step is
the jnp op on it: at bf16 / f16 every op rounds its result to that dtype, and
a Python scalar beside it (a payload, gelu's constants) is rounded to it
first, as jnp takes a weak-typed scalar. The JAX kernel stores its value in
x's dtype and raises where the chain's value has another (an int32 chain
through exp, a bf16 chain with an f32 side input); the port raises the same
(ValueError) on both tiers. An int32 chain of ops that keep integers runs
on the same kernel. Callers go through ``ops.dispatch.fused_chain``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from zgml_tpu_torch.ops import build
from zgml_tpu_torch.ops.attention import _sm_count
from zgml_tpu_torch.runtime.profile import global_profile

# step name -> the kernel's op code (csrc/elementwise.cu ChainOp), unary first
OPCODES = {name: i for i, name in enumerate(
    ("neg", "recip", "sqr", "sqrt", "exp", "log", "abs", "tanh", "sigmoid", "relu", "silu",
     "gelu", "scale", "add_scalar", "add", "sub", "mul", "div", "max2"))}
BINARY = ("add", "sub", "mul", "div", "max2")
MAX_STEPS, MAX_SIDES = 16, 8
# csrc/elementwise.cu: threads a block, f32 elements of a 16-byte vector, side
# inputs loaded before the step loop
THREADS, VEC, PRELOAD = 256, 4, 2
# how the kernel reads a side input (csrc/elementwise.cu SideMode)
SIDE_MODES = {"same": 0, "suffix": 1, "rows": 2, "scalar": 3}
# the dtypes the kernel computes in (csrc/elementwise.cu ChainType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.int32: 3}
# the placement counter of K13 by dtype (dispatch's fused_chain at f32)
COUNTERS = {torch.float32: "fused_chain", torch.bfloat16: "fused_chain_bf16",
            torch.float16: "fused_chain_f16", torch.int32: "fused_chain_i32"}

_SQRT_2_OVER_PI = float(np.float32(np.sqrt(2 / np.pi)))
_GELU_C = float(np.float32(0.044715))


class Step(NamedTuple):
    op: str                 # a key of OPCODES
    payload: float = 0.0    # scale / add_scalar
    side: int = -1          # binary: index into the side inputs
    side_left: bool = False  # binary: the side input is the left operand


def counter(dtype: torch.dtype) -> str:
    """K13's placement counter for a chain of `dtype` (f32: fused_chain)."""
    return COUNTERS.get(dtype, f"fused_chain_{str(dtype).removeprefix('torch.')}")


def vec_of(dtype: torch.dtype) -> int:
    """Elements of a 16-byte vector of `dtype` (K13's vectors)."""
    return 16 // torch.empty((), dtype=dtype).element_size()


def _weak(a: torch.Tensor, c):
    """A Python scalar beside `a` as jnp takes it (a weak type): a float
    rounded to a's dtype where that is a 16-bit float; as it is otherwise."""
    if isinstance(c, float) and a.dtype in (torch.bfloat16, torch.float16):
        return float(torch.tensor(np.float32(c), dtype=a.dtype))
    return c


def _gelu_tanh(a: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(approximate=True), term by term:
    x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x^3)))), its constants
    rounded to a's dtype."""
    x3 = a * (a * a)
    inner = _weak(a, _SQRT_2_OVER_PI) * (a + _weak(a, _GELU_C) * x3)
    return a * (0.5 * (1.0 + torch.tanh(inner)))


def _maximum(a: torch.Tensor, b) -> torch.Tensor:
    """jnp.maximum: NaN in either operand gives NaN (torch.maximum does)."""
    if not isinstance(b, torch.Tensor):
        b = a.new_full((), b)
    return torch.maximum(a, b)


def unary(op: str, a: torch.Tensor, payload: float = 0.0) -> torch.Tensor:
    """One unary step (zgml_tpu/graph/lower.py UNARY_FNS, SCALE, ADD_SCALAR)."""
    if op == "neg":
        return -a
    if op == "recip":
        return torch.reciprocal(a)
    if op == "sqr":
        return a * a
    if op == "sqrt":
        return torch.sqrt(a)
    if op == "exp":
        return torch.exp(a)
    if op == "log":
        return torch.log(a)
    if op == "abs":
        return torch.abs(a)
    if op == "tanh":
        return torch.tanh(a)
    if op == "sigmoid":
        return torch.sigmoid(a)
    if op == "relu":
        return _maximum(a, 0.0)
    if op == "silu":
        return a * torch.sigmoid(a)
    if op == "gelu":
        return _gelu_tanh(a)
    if op == "scale":
        return a * _weak(a, payload)
    if op == "add_scalar":
        return a + _weak(a, payload)
    raise NotImplementedError(f"unary step {op!r}")


def binary(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One binary step a (op) b (lower.py BINARY_FNS); torch broadcasts."""
    if op == "add":
        return a + b
    if op == "sub":
        return a - b
    if op == "mul":
        return a * b
    if op == "div":
        return a / b
    if op == "max2":
        return _maximum(a, b)
    raise NotImplementedError(f"binary step {op!r}")


def fused_chain_ref(x: torch.Tensor, steps: Sequence[Step],
                    sides: Sequence[torch.Tensor]) -> torch.Tensor:
    """The chain's plain composition: each step in turn on the chain value,
    side inputs broadcast to x's shape."""
    acc = x
    for st in steps:
        if st.op in BINARY:
            side = torch.broadcast_to(sides[st.side], x.shape)
            acc = binary(st.op, side, acc) if st.side_left else binary(st.op, acc, side)
        else:
            acc = unary(st.op, acc, st.payload)
    return acc


@functools.lru_cache(maxsize=None)
def chain_dtype(x_dtype: torch.dtype, steps: tuple, side_dtypes: tuple) -> torch.dtype:
    """The dtype of the chain's value: torch's type promotion through its
    steps (jnp's on these dtypes; a payload or constant is a weak scalar), on
    empty meta tensors."""
    acc = torch.empty(0, dtype=x_dtype, device="meta")
    for st in steps:
        if st.op in BINARY:
            side = torch.empty(0, dtype=side_dtypes[st.side], device="meta")
            acc = binary(st.op, side, acc) if st.side_left else binary(st.op, acc, side)
        else:
            acc = unary(st.op, acc, st.payload)
    return acc.dtype


def check_dtype(x: torch.Tensor, steps: Sequence[Step], sides: Sequence[torch.Tensor]):
    """Raise where the chain's value is not of x's dtype: the JAX kernel
    stores its value in an output of x's dtype and refuses another (an int32
    chain through exp or div, a bf16 chain with an f32 side input)."""
    dt = chain_dtype(x.dtype, tuple(steps), tuple(s.dtype for s in sides))
    if dt != x.dtype:
        raise ValueError(f"fused_chain: the chain's value is {dt}, x is {x.dtype}; the chain "
                         f"kernel stores x's dtype only (the JAX kernel's store refuses "
                         f"another)")


def check_steps(steps: Sequence[Step], n_sides: int):
    """Raise on a chain the kernel cannot take (unknown op, too many steps or
    side inputs, a side index out of range)."""
    if not 0 < len(steps) <= MAX_STEPS or n_sides > MAX_SIDES:
        raise ValueError(f"fused_chain: {len(steps)} steps and {n_sides} side inputs; takes "
                         f"1..{MAX_STEPS} and at most {MAX_SIDES}")
    for st in steps:
        if st.op not in OPCODES:
            raise ValueError(f"fused_chain: unknown step {st.op!r}")
        if st.op in BINARY and not 0 <= st.side < n_sides:
            raise ValueError(f"fused_chain: step {st.op!r} takes side {st.side} of {n_sides}")


class SideMap(NamedTuple):
    """How K13 reads a side input for element i of x: mode "same" side[i],
    "suffix" side[i % inner], "rows" side[i // inner], "scalar" side[0];
    "materialise": no such map, the wrapper broadcasts it to x's shape."""
    mode: str
    inner: int


def side_map(side_shape: Sequence[int], x_shape: Sequence[int]) -> SideMap:
    """The map of a side input of side_shape broadcast to x_shape: x's
    shape; x's trailing dims (leading 1s, e.g. a bias [d] or [1, d] on [M,
    d]); x's leading dims with trailing 1s (e.g. [M, 1]); one value; else
    "materialise" (e.g. [B, 1, d] on [B, M, d])."""
    side, xs = tuple(side_shape), tuple(x_shape)
    n = math.prod(xs)
    if len(side) > len(xs):
        return SideMap("materialise", n)
    if math.prod(side) == 1:
        return SideMap("scalar", 1)
    s = (1,) * (len(xs) - len(side)) + side
    if s == xs:
        return SideMap("same", n)
    for k in range(1, len(xs)):
        if all(v == 1 for v in s[:k]) and s[k:] == xs[k:]:
            return SideMap("suffix", math.prod(xs[k:]))
        if s[:k] == xs[:k] and all(v == 1 for v in s[k:]):
            return SideMap("rows", math.prod(xs[k:]))
    return SideMap("materialise", n)


class _Step(ctypes.Structure):
    _fields_ = [("op", ctypes.c_int), ("side", ctypes.c_int), ("side_left", ctypes.c_int),
                ("payload", ctypes.c_float), ("ipayload", ctypes.c_int)]


class _Side(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p), ("inner", ctypes.c_longlong), ("mode", ctypes.c_int),
                ("vec", ctypes.c_int)]


class _Program(ctypes.Structure):
    """csrc/elementwise.cu Program, handed to the launcher by pointer."""
    _fields_ = [("steps", _Step * MAX_STEPS), ("sides", _Side * MAX_SIDES),
                ("n_steps", ctypes.c_int), ("n_sides", ctypes.c_int)]


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(index: int, code: int, pre: int, wide: bool) -> int:
    n = ctypes.c_int(0)
    with torch.cuda.device(index):
        build.check(build.library().zgml_fused_chain_blocks_per_sm(code, pre, int(wide),
                                                                   ctypes.byref(n)),
                    "fused_chain occupancy")
    if n.value < 1:
        raise RuntimeError("fused_chain: no block fits on an SM")
    return n.value


def chain_blocks(n: int, sm_count: int, per_sm: int, vec: int = VEC) -> int:
    """K13's grid for n elements of `vec` a 16-byte vector on a card holding
    per_sm blocks on each of sm_count SMs: the fewest vectors a thread that
    one wave of blocks covers the n / vec vectors with, and the fewest blocks
    that cover them at that many a thread (so the threads' shares differ by
    one at most)."""
    vectors = max(1, -(-n // vec))
    each = -(-vectors // (THREADS * sm_count * per_sm))
    return -(-vectors // (THREADS * each))


def index_wide(n: int, blocks: int) -> bool:
    """Whether K13 over n elements on `blocks` blocks takes 64-bit indices
    (csrc/elementwise.cu tests the same): its element loop steps an index
    below n by the grid's threads, so 32-bit indices hold only where n plus
    that step stays below 2^31."""
    return n + blocks * THREADS >= 2 ** 31


def chain_grid(n: int, sm_count: int, per_sm: Callable[[bool], int],
               vec: int = VEC) -> tuple[int, bool]:
    """(blocks, wide) of K13's launch over n elements: chain_blocks at the
    occupancy per_sm(wide) of the 32-bit instantiation, or of the 64-bit
    one where that grid makes index_wide true."""
    blocks = chain_blocks(n, sm_count, per_sm(False), vec)
    if not index_wide(n, blocks):
        return blocks, False
    blocks = chain_blocks(n, sm_count, per_sm(True), vec)
    return blocks, index_wide(n, blocks)


def fused_chain_cuda(x: torch.Tensor, steps: Sequence[Step],
                     sides: Sequence[torch.Tensor]) -> torch.Tensor:
    """Launch K13 (csrc/elementwise.cu): x on the card, f32, bf16, f16 or
    int32, side inputs broadcastable to x's shape -> the chain's value, of
    x's dtype and shape. A side input of another dtype is cast to x's first
    (type promotion's cast: exact for a narrower float), then read in place
    through its side_map, or materialised at x's shape where it has none.
    Raises where the chain's value is not of x's dtype (check_dtype)."""
    if x.dtype not in DTYPE_CODES:
        raise NotImplementedError(f"fused_chain: K13 takes {list(DTYPE_CODES)} chains, got "
                                  f"{x.dtype}")
    if not x.is_cuda or any(s.device != x.device for s in sides):
        raise ValueError(f"fused_chain: x on {x.device}: x and every side input must be on one "
                         f"CUDA device")
    check_steps(steps, len(sides))
    check_dtype(x, steps, sides)
    integer = not x.dtype.is_floating_point
    xc = x.contiguous()
    out = torch.empty_like(xc)
    n = xc.numel()
    prog = _Program(n_steps=len(steps), n_sides=len(sides))
    for i, st in enumerate(steps):
        ipay = int(st.payload) if integer and st.op in ("scale", "add_scalar") else 0
        if not -2 ** 31 <= ipay < 2 ** 31:
            raise ValueError(f"fused_chain: int32 chain payload {st.payload} out of range")
        pay = 0.0 if integer else _weak(x, float(st.payload))
        prog.steps[i] = _Step(OPCODES[st.op], int(st.side), int(bool(st.side_left)), pay, ipay)
    keep = []                       # the side tensors, alive until the launch
    for i, s in enumerate(sides):
        s = s.to(x.dtype)
        sm = side_map(s.shape, x.shape)
        if sm.mode == "materialise":
            s, sm = torch.broadcast_to(s, x.shape), SideMap("same", n)
        s = s.contiguous()
        keep.append(s)
        prog.sides[i] = _Side(s.data_ptr(), sm.inner, SIDE_MODES[sm.mode], 0)
    index, pre, code = x.device.index or 0, min(len(sides), PRELOAD), DTYPE_CODES[x.dtype]
    blocks, _ = chain_grid(n, _sm_count(index),
                           lambda wide: _blocks_per_sm(index, code, pre, wide), vec_of(x.dtype))
    status = build.library().zgml_fused_chain(
        code, xc.data_ptr(), out.data_ptr(), n, ctypes.byref(prog), blocks,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "fused_chain")
    global_profile.count_op(counter(x.dtype), "cuda")
    return out


class FusedChain(torch.autograd.Function):
    """``apply(x, steps, kernel, *sides)``: K13 where `kernel` is true, else
    the plain composition (counted as a "ref" placement); the backward
    recomputes the plain composition under autograd, on either tier (counted
    as "fused_chain_bwd", plain torch by design)."""

    @staticmethod
    def forward(ctx, x, steps, kernel, *sides):
        ctx.save_for_backward(x, *sides)
        ctx.steps = steps
        if kernel:
            return fused_chain_cuda(x, steps, sides)
        global_profile.count_op(counter(x.dtype), "ref")
        return fused_chain_ref(x, steps, sides)

    @staticmethod
    def backward(ctx, g):
        x, *sides = ctx.saved_tensors
        global_profile.count_op("fused_chain_bwd", "torch")
        leaves = [t.detach().requires_grad_() if t.is_floating_point() else t.detach()
                  for t in (x, *sides)]
        wrt = [t for t in leaves if t.requires_grad]
        with torch.enable_grad():
            out = fused_chain_ref(leaves[0], ctx.steps, leaves[1:])
            grads = iter(torch.autograd.grad(out, wrt, g, allow_unused=True))
        dx, *dsides = [next(grads) if t.requires_grad else None for t in leaves]
        return (dx, None, None, *dsides)
