"""K13's plain version (ops/elementwise.py) against the JAX fused_chain.

The JAX side runs `zgml_tpu.ops.elementwise.fused_chain` in Pallas interpret
mode (tests/conftest.py) with the JAX lowering's own callables
(zgml_tpu/graph/lower.py UNARY_FNS, BINARY_FNS); where the chain value is the
right operand, the JAX step is given as fn(side, acc), which is what the
graph computes. Shapes are not multiples of 128 (JAX pads to [rows, 128]),
and side inputs broadcast from [W] and [R, 1].

K13 reads a side input in place through ``side_map`` (x's shape, its
trailing dims, its leading dims with trailing 1s, one value) where it can:
gathering each side through its map gives torch.broadcast_to's values, and
the maps it cannot take come back as "materialise". The plain chain with a
bias [W], an [R, 1] and a scalar side input equals the JAX chain on the same
inputs.

Tolerances: the ops that are exact in IEEE f32 (add, sub, mul, div, max2,
neg, recip, sqr, abs, relu, scale, add_scalar) are bit-equal on both CPUs;
sqrt is exact in IEEE too, but XLA's CPU sqrt is one ulp off in about 1% of
the values (measured), so it is held with exp, log, tanh, sigmoid, silu and
gelu, which come from two libraries' CPU code: within 2e-7 * max|out|. NaN
goes through max2 and relu in either package. Gradients through
elementwise.FusedChain (plain recompute) agree with jax.grad through the JAX
custom VJP within 1e-5 * max|g| (f32 sums of the broadcast side's gradient
in another order).
"""
import ctypes

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from zgml_tpu.graph.lower import BINARY_FNS, UNARY_FNS
from zgml_tpu.graph.op import Op as JOp
from zgml_tpu.ops.elementwise import fused_chain as jax_fused_chain

from zgml_tpu_torch.ops import dispatch
from zgml_tpu_torch.ops.elementwise import (BINARY, OPCODES, THREADS, VEC, FusedChain, Step,
                                            _Program, chain_blocks, chain_grid, fused_chain_ref,
                                            index_wide, side_map)
from zgml_tpu_torch.runtime.profile import global_profile

torch.set_num_threads(1)
SHAPE = (7, 45)
EXACT = {"add", "sub", "mul", "div", "max2", "neg", "recip", "sqr", "abs", "relu", "scale",
         "add_scalar"}
TRANS_RTOL = 2e-7
GRAD_RTOL = 1e-5
PAYLOAD = {"scale": 0.37, "add_scalar": -1.25}


def _jax_fn(op: str, payload: float, side_left: bool):
    """The JAX step (callable, takes_side) for one of our steps."""
    if op in PAYLOAD:
        return ((lambda a: a * payload) if op == "scale" else (lambda a: a + payload)), False
    jop = JOp(op)
    if op in BINARY:
        fn = BINARY_FNS[jop]
        return ((lambda a, s: fn(s, a)) if side_left else fn), True
    return UNARY_FNS[jop], False


def _run_jax(x, steps, sides):
    jsteps = [_jax_fn(st.op, st.payload, st.side_left) for st in steps]
    # the JAX chain takes its side inputs in step order
    jsides = [jnp.asarray(sides[st.side]) for st in steps if st.op in BINARY]
    return np.asarray(jax_fused_chain(jnp.asarray(x), jsteps, jsides))


def _input(op, rng):
    x = rng.standard_normal(SHAPE).astype(np.float32)
    if op in ("log", "sqrt"):
        x = np.abs(x) + 0.05
    if op == "recip":
        x = np.where(np.abs(x) < 0.05, 0.5, x).astype(np.float32)
    return x


def _compare(got, want, exact):
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    g, w = got[~nan], want[~nan]
    if exact:
        np.testing.assert_array_equal(g, w)
    else:
        assert float(np.max(np.abs(g - w))) <= TRANS_RTOL * float(np.max(np.abs(w)))


CASES = [(op, False) for op in OPCODES] + [(op, True) for op in BINARY]


@pytest.mark.parametrize("op,side_left", CASES,
                         ids=[f"{op}{'-right' if sl else ''}" for op, sl in CASES])
def test_step_matches_jax(op, side_left):
    """One step per op, and each binary op with the chain value on either
    side; the side input broadcast from [W]."""
    rng = np.random.default_rng(OPCODES[op] + 31 * side_left)
    x = _input(op, rng)
    side = rng.standard_normal(SHAPE[1]).astype(np.float32)
    if op == "div":
        side = np.where(np.abs(side) < 0.05, 0.5, side).astype(np.float32)
        if side_left:
            x = np.where(np.abs(x) < 0.05, 0.5, x).astype(np.float32)
    steps = [Step(op, PAYLOAD.get(op, 0.0), 0 if op in BINARY else -1, side_left)]
    got = fused_chain_ref(torch.from_numpy(x), steps, [torch.from_numpy(side)]).numpy()
    _compare(got, _run_jax(x, steps, [side]), op in EXACT)


CHAINS = {
    # the smoke's graph_ffn chains
    "silu_mul": [Step("silu"), Step("mul", side=0)],
    "add_sqr": [Step("add", side=0), Step("sqr")],
    # a long chain over every kind of step, two side inputs, both operand orders
    "long": [Step("neg"), Step("exp"), Step("scale", 0.5), Step("add", side=0),
             Step("div", side=1, side_left=True), Step("tanh"), Step("sub", side=0,
                                                                     side_left=True),
             Step("gelu"), Step("max2", side=1), Step("add_scalar", 0.75), Step("sigmoid"),
             Step("log"), Step("abs"), Step("sqrt"), Step("relu"), Step("mul", side=1)],
}


@pytest.mark.parametrize("name", list(CHAINS))
def test_chain_matches_jax(name):
    """Whole chains, the side inputs broadcast from [R, 1] and [W]."""
    rng = np.random.default_rng(len(name))
    x = rng.standard_normal(SHAPE).astype(np.float32)
    sides = [rng.standard_normal((SHAPE[0], 1)).astype(np.float32),
             (1.5 + rng.random(SHAPE[1])).astype(np.float32)]
    steps = CHAINS[name]
    got = fused_chain_ref(torch.from_numpy(x), steps, [torch.from_numpy(s) for s in sides])
    want = _run_jax(x, steps, sides)
    assert float(np.max(np.abs(got.numpy() - want))) <= 1e-6 * float(np.max(np.abs(want)))


def test_gelu_is_the_tanh_form():
    """jax.nn.gelu's default is the tanh approximation; torch's F.gelu
    defaults to erf. The plain step is the tanh form."""
    x = torch.linspace(-4, 4, 81)
    got = fused_chain_ref(x, [Step("gelu")], [])
    tanh_form = torch.nn.functional.gelu(x, approximate="tanh")
    erf_form = torch.nn.functional.gelu(x)
    assert float((got - tanh_form).abs().max()) <= 1e-6
    assert float((got - erf_form).abs().max()) > 1e-4
    want = np.asarray(jax.nn.gelu(jnp.asarray(x.numpy())))
    assert float(np.max(np.abs(got.numpy() - want))) <= TRANS_RTOL * float(np.max(np.abs(want)))


@pytest.mark.parametrize("op", ["relu", "max2"])
def test_nan_propagates(op):
    """jnp.maximum gives NaN where either operand is NaN; so do the plain
    max2 and relu (and K13, csrc/elementwise.cu nan_max)."""
    x = np.array([[np.nan, 1.0, -2.0, np.nan], [0.5, -0.5, 3.0, -1.0]], np.float32)
    side = np.array([2.0, np.nan, -3.0, np.nan], np.float32)
    steps = [Step(op, side=0 if op == "max2" else -1)]
    got = fused_chain_ref(torch.from_numpy(x), steps, [torch.from_numpy(side)]).numpy()
    want = _run_jax(x, steps, [side])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[0, 0]) and (op == "relu" or np.isnan(got[1, 1]))
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])


@pytest.mark.parametrize("name", list(CHAINS))
def test_backward_matches_jax_vjp(name):
    """Gradients of sum(chain * w) with respect to x and each side input:
    FusedChain's plain recompute against jax.grad through the custom VJP."""
    rng = np.random.default_rng(7 + len(name))
    x = rng.standard_normal(SHAPE).astype(np.float32)
    sides = [rng.standard_normal((SHAPE[0], 1)).astype(np.float32),
             (1.5 + rng.random(SHAPE[1])).astype(np.float32)]
    w = rng.standard_normal(SHAPE).astype(np.float32)
    steps = CHAINS[name]
    n_sides = 1 + max(st.side for st in steps)
    sides = sides[:n_sides]
    jsteps = [_jax_fn(st.op, st.payload, st.side_left) for st in steps]
    order = [st.side for st in steps if st.op in BINARY]

    def jloss(x_, *s_):
        return jnp.sum(jax_fused_chain(x_, jsteps, [s_[i] for i in order]) * w)
    jg = jax.grad(jloss, argnums=tuple(range(1 + n_sides)))(
        jnp.asarray(x), *(jnp.asarray(s) for s in sides))

    xt = torch.from_numpy(x).requires_grad_()
    st_ = [torch.from_numpy(s).requires_grad_() for s in sides]
    global_profile.reset()
    out = FusedChain.apply(xt, tuple(steps), False, *st_)
    pg = torch.autograd.grad((out * torch.from_numpy(w)).sum(), [xt, *st_])
    assert global_profile.tier_summary() == {"fused_chain": {"ref": 1},
                                             "fused_chain_bwd": {"torch": 1}}
    for got, want in zip(pg, jg):
        want = np.asarray(want)
        assert got.shape == want.shape
        assert float(np.max(np.abs(got.numpy() - want))) <= GRAD_RTOL * float(
            np.max(np.abs(want)))


def test_dispatch_runs_the_plain_chain_on_the_cpu():
    """On the CPU dispatch.fused_chain runs the plain composition, counted
    under ref, and under autograd FusedChain."""
    x = torch.randn(3, 5)
    s = torch.randn(5, requires_grad=True)
    steps = [Step("exp"), Step("mul", side=0)]
    global_profile.reset()
    with torch.no_grad():
        y = dispatch.fused_chain(x, steps, [s])
    y2 = dispatch.fused_chain(x, steps, [s])
    assert y2.grad_fn is not None and torch.equal(y, y2.detach())
    assert global_profile.tier_summary() == {"fused_chain": {"ref": 2}}


B_, M_, D_ = 2, 3, 5
# (side shape, x shape, the map side_map must give)
SIDE_MAPS = [((D_,), (M_, D_), "suffix"), ((D_,), (B_, M_, D_), "suffix"),
             ((1, D_), (M_, D_), "suffix"), ((1, D_), (B_, M_, D_), "suffix"),
             ((M_, 1), (M_, D_), "rows"), ((M_, 1), (B_, M_, D_), "materialise"),
             ((), (M_, D_), "scalar"), ((), (B_, M_, D_), "scalar"),
             ((1,), (M_, D_), "scalar"), ((1,), (B_, M_, D_), "scalar"),
             ((M_, D_), (M_, D_), "same"), ((M_, D_), (B_, M_, D_), "suffix"),
             ((B_, 1, D_), (B_, M_, D_), "materialise"), ((B_, M_, 1), (B_, M_, D_), "rows"),
             ((B_, 1, 1), (B_, M_, D_), "rows"), ((1, M_, 1), (B_, M_, D_), "materialise")]


@pytest.mark.parametrize("side_shape,x_shape,mode", SIDE_MAPS,
                         ids=[f"{list(s)}-on-{list(x)}" for s, x, _ in SIDE_MAPS])
def test_side_map_reads_the_broadcast(side_shape, x_shape, mode):
    """Element i of x reads side[i], side[i % inner], side[i // inner] or
    side[0] (csrc/elementwise.cu load_side): the gathered side equals
    torch.broadcast_to's."""
    sm = side_map(side_shape, x_shape)
    assert sm.mode == mode
    if mode == "materialise":
        return
    side = torch.arange(1, 1 + int(np.prod(side_shape)), dtype=torch.float32).reshape(side_shape)
    i = torch.arange(int(np.prod(x_shape)))
    idx = {"same": i, "suffix": i % sm.inner, "rows": i // sm.inner,
           "scalar": torch.zeros_like(i)}[mode]
    want = torch.broadcast_to(side, x_shape).reshape(-1)
    assert torch.equal(side.reshape(-1)[idx], want)


# no product feeds a sum in the exact chain: XLA's CPU backend contracts the
# two into an FMA (measured: mul -> sub differs in 41 of 315 values), which
# the plain version and K13 do not
MAPPED_CHAINS = {
    "exact": ([Step("add", side=0), Step("div", side=1, side_left=True), Step("sub", side=2),
               Step("max2", side=0, side_left=True), Step("mul", side=2)], True),
    "transcendental": ([Step("add", side=0), Step("tanh"), Step("mul", side=1),
                        Step("sub", side=2, side_left=True), Step("exp")], False),
}


@pytest.mark.parametrize("name", list(MAPPED_CHAINS))
def test_chain_with_mapped_sides_matches_jax(name):
    """A bias [W] (suffix), an [R, 1] (rows) and a scalar side input, the
    forms K13 reads in place: the plain chain against the JAX chain on the
    same numpy inputs, bit-equal where every step is exact in IEEE f32, else
    within 1e-6 * max|out|."""
    rng = np.random.default_rng(40 + len(name))
    x = rng.standard_normal(SHAPE).astype(np.float32)
    sides = [rng.standard_normal(SHAPE[1]).astype(np.float32),
             rng.standard_normal((SHAPE[0], 1)).astype(np.float32),
             np.asarray(rng.standard_normal() + 3.0, np.float32)]
    assert [side_map(s.shape, SHAPE).mode for s in sides] == ["suffix", "rows", "scalar"]
    steps, exact = MAPPED_CHAINS[name]
    got = fused_chain_ref(torch.from_numpy(x), steps, [torch.from_numpy(s) for s in sides])
    want = _run_jax(x, steps, sides)
    if exact:
        _compare(got.numpy(), want, True)
    else:
        assert float(np.max(np.abs(got.numpy() - want))) <= 1e-6 * float(np.max(np.abs(want)))


def test_program_layout_matches_the_kernel():
    """ops/elementwise._Program is csrc/elementwise.cu's Program (its
    static_assert: 520 bytes), field by field."""
    assert ctypes.sizeof(_Program) == 520
    assert (_Program.steps.offset, _Program.sides.offset, _Program.n_steps.offset,
            _Program.n_sides.offset) == (0, 320, 512, 516)


@pytest.mark.parametrize("n", [1, 315, 4099, 512 * 2048, 512 * 5632, 2048 * 2048, 2 ** 31 + 8])
@pytest.mark.parametrize("per_sm", [1, 3, 4, 8])
def test_chain_blocks_one_wave_even_shares(n, per_sm):
    """K13's grid fits one wave of the card's blocks, and covers the n / VEC
    vectors with every thread's share within one vector of the others."""
    sms = 132
    blocks = chain_blocks(n, sms, per_sm)
    vectors = -(-n // VEC)
    threads = blocks * THREADS
    assert 1 <= blocks <= sms * per_sm
    each = -(-vectors // threads)
    assert (blocks - 1) * THREADS * each < vectors <= threads * each


@pytest.mark.parametrize("n", [2 ** 20, 2 ** 31 - 2 ** 20, 2 ** 31 - 270_000, 2 ** 31 - 4099,
                               2 ** 31 - 8, 2 ** 31 - 1, 2 ** 31 + 8])
@pytest.mark.parametrize("per_sm", [(8, 8), (8, 4), (2, 1)], ids=["8-8", "8-4", "2-1"])
def test_chain_grid_takes_32_bit_indices_only_where_they_cannot_overflow(n, per_sm):
    """K13's index type: 32-bit only where no index its loops compute passes
    2^31 - 1. Where x is not 16-byte aligned the element loop covers all n:
    thread t computes t, t + stride, ... up to the first value >= n. The
    vector loop's indices (in vectors) stay below n / VEC + 2 * stride."""
    sms = 132
    blocks, wide = chain_grid(n, sms, lambda w: per_sm[w])
    narrow = chain_blocks(n, sms, per_sm[0])
    assert blocks == (chain_blocks(n, sms, per_sm[1]) if index_wide(n, narrow) else narrow)
    assert wide == index_wide(n, blocks)
    stride = blocks * THREADS
    t = np.arange(min(stride, n), dtype=np.int64)
    last = int((t + -(-(n - t) // stride) * stride).max())
    if not wide:
        assert last <= 2 ** 31 - 1 and n // VEC + 2 * stride <= 2 ** 31 - 1
    # below 2^31 elements and still 64-bit: within one grid stride of it
    assert wide == (n + stride >= 2 ** 31)
    assert wide == (n >= 2 ** 31 - 4099) or 2 ** 20 < n < 2 ** 31 - 4099
