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
  fused_chain_cuda  launch csrc/elementwise.cu (f32 only)
  fused_chain_ref   the plain composition of the same steps in torch
  FusedChain        K13 (or the plain version) forward; the backward recomputes
                    the plain composition under autograd, as `_chain_bwd` does
                    (elementwise.py:60-63)

The ops are the graph tier's elementwise lowering rules (graph/lower.py calls
``unary`` and ``binary`` here), so a chain fused or not computes the same
function. Callers go through ``ops.dispatch.fused_chain``.
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
# csrc/elementwise.cu: threads a block, elements of a 16-byte vector, side
# inputs loaded before the step loop
THREADS, VEC, PRELOAD = 256, 4, 2
# how the kernel reads a side input (csrc/elementwise.cu SideMode)
SIDE_MODES = {"same": 0, "suffix": 1, "rows": 2, "scalar": 3}
# the ROADMAP item of K13's other dtypes
OTHER_DTYPES = "ROADMAP.md B.4"

_SQRT_2_OVER_PI = float(np.float32(np.sqrt(2 / np.pi)))


class Step(NamedTuple):
    op: str                 # a key of OPCODES
    payload: float = 0.0    # scale / add_scalar
    side: int = -1          # binary: index into the side inputs
    side_left: bool = False  # binary: the side input is the left operand


def _gelu_tanh(a: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(approximate=True), term by term:
    x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x^3))))."""
    x3 = a * (a * a)
    return a * (0.5 * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (a + 0.044715 * x3))))


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
        return a * payload
    if op == "add_scalar":
        return a + payload
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
                ("payload", ctypes.c_float)]


class _Side(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p), ("inner", ctypes.c_longlong), ("mode", ctypes.c_int),
                ("vec", ctypes.c_int)]


class _Program(ctypes.Structure):
    """csrc/elementwise.cu Program, handed to the launcher by pointer."""
    _fields_ = [("steps", _Step * MAX_STEPS), ("sides", _Side * MAX_SIDES),
                ("n_steps", ctypes.c_int), ("n_sides", ctypes.c_int)]


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(index: int, pre: int, wide: bool) -> int:
    n = ctypes.c_int(0)
    with torch.cuda.device(index):
        build.check(build.library().zgml_fused_chain_blocks_per_sm(pre, int(wide),
                                                                   ctypes.byref(n)),
                    "fused_chain occupancy")
    if n.value < 1:
        raise RuntimeError("fused_chain: no block fits on an SM")
    return n.value


def chain_blocks(n: int, sm_count: int, per_sm: int) -> int:
    """K13's grid for n elements on a card holding per_sm blocks on each of
    sm_count SMs: the fewest vectors a thread that one wave of blocks
    covers the n / VEC vectors with, and the fewest blocks that cover them
    at that many a thread (so the threads' shares differ by one at most)."""
    vectors = max(1, -(-n // VEC))
    each = -(-vectors // (THREADS * sm_count * per_sm))
    return -(-vectors // (THREADS * each))


def index_wide(n: int, blocks: int) -> bool:
    """Whether K13 over n elements on `blocks` blocks takes 64-bit indices
    (csrc/elementwise.cu tests the same): its element loop steps an index
    below n by the grid's threads, so 32-bit indices hold only where n plus
    that step stays below 2^31."""
    return n + blocks * THREADS >= 2 ** 31


def chain_grid(n: int, sm_count: int, per_sm: Callable[[bool], int]) -> tuple[int, bool]:
    """(blocks, wide) of K13's launch over n elements: chain_blocks at the
    occupancy per_sm(wide) of the 32-bit instantiation, or of the 64-bit
    one where that grid makes index_wide true."""
    blocks = chain_blocks(n, sm_count, per_sm(False))
    if not index_wide(n, blocks):
        return blocks, False
    blocks = chain_blocks(n, sm_count, per_sm(True))
    return blocks, index_wide(n, blocks)


def fused_chain_cuda(x: torch.Tensor, steps: Sequence[Step],
                     sides: Sequence[torch.Tensor]) -> torch.Tensor:
    """Launch K13 (csrc/elementwise.cu): x f32 on the card, side inputs f32
    broadcastable to x's shape -> the chain's value, f32 of x's shape. A
    side input is read in place through its side_map, or materialised at
    x's shape where it has none."""
    if x.dtype != torch.float32 or any(s.dtype != torch.float32 for s in sides):
        raise NotImplementedError(
            f"fused_chain: K13 takes float32 chains, got x {x.dtype} and sides "
            f"{[s.dtype for s in sides]} ({OTHER_DTYPES})")
    if not x.is_cuda or any(s.device != x.device for s in sides):
        raise ValueError(f"fused_chain: x on {x.device}: x and every side input must be on one "
                         f"CUDA device")
    check_steps(steps, len(sides))
    xc = x.contiguous()
    out = torch.empty_like(xc)
    n = xc.numel()
    prog = _Program(n_steps=len(steps), n_sides=len(sides))
    for i, st in enumerate(steps):
        prog.steps[i] = _Step(OPCODES[st.op], int(st.side), int(bool(st.side_left)),
                              float(st.payload))
    keep = []                       # the side tensors, alive until the launch
    for i, s in enumerate(sides):
        sm = side_map(s.shape, x.shape)
        if sm.mode == "materialise":
            s, sm = torch.broadcast_to(s, x.shape), SideMap("same", n)
        s = s.contiguous()
        keep.append(s)
        prog.sides[i] = _Side(s.data_ptr(), sm.inner, SIDE_MODES[sm.mode], 0)
    index, pre = x.device.index or 0, min(len(sides), PRELOAD)
    blocks, _ = chain_grid(n, _sm_count(index), lambda wide: _blocks_per_sm(index, pre, wide))
    status = build.library().zgml_fused_chain(
        xc.data_ptr(), out.data_ptr(), n, ctypes.byref(prog), blocks,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "fused_chain")
    global_profile.count_op("fused_chain", "cuda")
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
        global_profile.count_op("fused_chain", "ref")
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
