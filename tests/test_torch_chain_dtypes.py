"""K13 on chains that are not f32: the port's plain chain (the function K13
computes on the card) against the JAX package's `fused_chain` (Pallas in
interpret mode) on the same numpy inputs.

Each step of a bf16 / f16 chain is the torch op on that dtype, its result
rounded to it, a Python scalar beside it rounded to it first (jnp's weak
type). XLA on the CPU keeps excess precision inside a fused chain and uses
its own transcendentals, so the JAX kernel is not one rounding order: the
two are held within CHAIN_ULPS units in the last place of the dtype per
element, at the element's magnitude. Where a step cancels (gelu's 1 +
tanh(v) at v << 0, log near 1, a difference of near values) a one-ulp
move of its operand is many ulps of its result; there the bound is
CHAIN_ULPS ulps at max|ref| (measured at f16: gelu 190 ulps per element at
-0.004 from JAX, 1 at max|ref|). An int32 chain of ops that keep integers is computed by both and
equal; where a step makes the value another dtype (an int32 chain through
exp, a bf16 chain with an f32 side input) the JAX kernel's store raises, and
the port raises ValueError on both tiers. A bf16 graph runs through both
packages' ComputeGraph within the same bound.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import zgml_tpu.graph as jgraph
from zgml_tpu.graph.lower import BINARY_FNS, UNARY_FNS
from zgml_tpu.graph.op import Op as JOp
from zgml_tpu.ops.elementwise import fused_chain as jax_chain

import zgml_tpu_torch.graph as tgraph
from zgml_tpu_torch.ops import dispatch
from zgml_tpu_torch.ops.elementwise import (Step, chain_dtype, check_dtype, fused_chain_ref,
                                            vec_of)
from zgml_tpu_torch.runtime.profile import global_profile

torch.set_num_threads(1)
CHAIN_ULPS = 2
SHAPE = (64, 256)
DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "f16": (torch.float16, jnp.float16)}
# (label, steps, whether a step cancels); binary steps take side i (the chain
# value as the left operand)
CHAINS = [
    ("probe", [Step("exp"), Step("mul", side=0), Step("tanh"), Step("silu"),
               Step("add", side=1)], False),
    ("gelu", [Step("scale", 1.7), Step("gelu")], True),
    ("sigmoid_div", [Step("sigmoid"), Step("div", side=0), Step("add_scalar", 0.3)], False),
    ("sqrt_log", [Step("abs"), Step("add_scalar", 0.25), Step("sqrt"), Step("log"),
                  Step("sub", side=1)], True),
    ("recip_relu", [Step("add_scalar", 3.0), Step("recip"), Step("neg"), Step("relu"),
                    Step("max2", side=0), Step("sqr")], False),
]


def ulp(v: np.ndarray, dtype) -> np.ndarray:
    """The spacing of `dtype` (bf16: 8 significant bits, f16: 11) at |v|,
    from frexp, with the dtype's smallest subnormal as its floor."""
    bits, tiny = (8, 2.0 ** -133) if dtype == torch.bfloat16 else (11, 2.0 ** -24)
    _, e = np.frexp(np.abs(v).astype(np.float64))
    return np.maximum(np.ldexp(1.0, e - bits), tiny)


def within_ulps(got: np.ndarray, want: np.ndarray, dtype, n: int,
                at_max: bool = False) -> tuple[bool, float]:
    """Whether |got - want| <= n ulps of dtype per element, at the element's
    magnitude (or, at_max, at max|want|), and the worst count."""
    got, want = got.astype(np.float64), want.astype(np.float64)
    mag = np.max(np.abs(want)) if at_max else np.maximum(np.abs(got), np.abs(want))
    spacing = ulp(mag, dtype)
    worst = float(np.max(np.abs(got - want) / spacing))
    return worst <= n, worst


def _inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2.0, 2.0, SHAPE).astype(np.float32)
    sides = [rng.uniform(0.5, 1.5, SHAPE).astype(np.float32) for _ in range(2)]
    return x, sides


def _jax_steps(steps):
    """The port's steps as the JAX kernel's callables (the chain value always
    the left operand, as the JAX kernel calls fn(acc, side))."""
    out = []
    for st in steps:
        if st.op == "scale":
            out.append(((lambda p: lambda a: a * p)(st.payload), False))
        elif st.op == "add_scalar":
            out.append(((lambda p: lambda a: a + p)(st.payload), False))
        elif st.op in ("add", "sub", "mul", "div", "max2"):
            assert not st.side_left
            out.append((BINARY_FNS[JOp(st.op)], True))
        else:
            out.append((UNARY_FNS[JOp(st.op)], False))
    return out


def _jax_sides(steps, sides):
    """Side inputs in the order the JAX kernel consumes them (one per binary step)."""
    return [sides[st.side] for st in steps if st.op in ("add", "sub", "mul", "div", "max2")]


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("label,steps,cancels", CHAINS, ids=[c[0] for c in CHAINS])
def test_plain_chain_matches_jax_within_ulps(dt, label, steps, cancels):
    tdt, jdt = DTYPES[dt]
    x, sides = _inputs()
    xt = torch.from_numpy(x).to(tdt)
    st = [torch.from_numpy(s).to(tdt) for s in sides]
    got = fused_chain_ref(xt, steps, st)
    assert got.dtype == tdt
    want = jax_chain(jnp.asarray(xt.float().numpy()).astype(jdt), _jax_steps(steps),
                     [jnp.asarray(s.float().numpy()).astype(jdt) for s in _jax_sides(steps, st)])
    assert want.dtype == jdt
    ok, worst = within_ulps(got.float().numpy(), np.asarray(want.astype(jnp.float32)), tdt,
                            CHAIN_ULPS, at_max=cancels)
    assert ok, f"{dt} {label}: {worst:.2f} ulps from JAX"


@pytest.mark.parametrize("dt", list(DTYPES))
def test_dispatch_runs_16_bit_chains_on_the_cpu(dt):
    """dispatch.fused_chain takes a bf16 / f16 chain (it no longer raises),
    computes the plain chain, counted under `ref`, and its value keeps x's
    dtype; the backward recomputes in that dtype."""
    tdt, _ = DTYPES[dt]
    x, sides = _inputs(1)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    st = [torch.from_numpy(s).to(tdt) for s in sides]
    steps = CHAINS[0][1]
    global_profile.reset()
    out = dispatch.fused_chain(xt, steps, st)
    assert out.dtype == tdt
    assert global_profile.tier_summary()[f"fused_chain_{dt}"] == {"ref": 1}
    assert torch.equal(out.detach(), fused_chain_ref(xt.detach(), steps, st))
    (g,) = torch.autograd.grad(out.float().sum(), xt)
    assert g.dtype == tdt and bool(torch.isfinite(g.float()).all())


def test_weak_payload_is_rounded_to_the_chain_dtype():
    """scale by a Python float on a bf16 chain multiplies by bf16(p), as jnp
    does with a weak-typed scalar (not by fl32(p), which differs here on
    some elements); JAX's kernel gives the same bits."""
    x = torch.linspace(1.0, 2.0, 129).to(torch.bfloat16)
    p = 1.0 + 2.0 ** -8 + 2.0 ** -11          # bf16(p) = 1 + 2^-7
    got = fused_chain_ref(x, [Step("scale", p)], [])
    weak = (x.float() * (1.0 + 2.0 ** -7)).to(torch.bfloat16)
    strong = (x.float() * np.float32(p)).to(torch.bfloat16)
    assert torch.equal(got, weak) and not torch.equal(got, strong)
    want = jax_chain(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                     [(lambda a: a * p, False)], [])
    np.testing.assert_array_equal(np.asarray(want.astype(jnp.float32)), got.float().numpy())


@pytest.mark.parametrize("x_dt,side_dt", [("bf16", torch.float32), ("bf16", torch.float16),
                                          ("f16", torch.float32)])
def test_a_promoting_side_raises_as_jax_does(x_dt, side_dt):
    """A 16-bit chain with a side input of a wider or other float dtype:
    its value becomes f32, which the JAX kernel refuses to store in x's
    dtype; the port raises ValueError on both tiers."""
    tdt, jdt = DTYPES[x_dt]
    x, sides = _inputs(2)
    steps = [Step("mul", side=0)]
    jside = jnp.asarray(sides[0]).astype({torch.float32: jnp.float32,
                                          torch.float16: jnp.float16}[side_dt])
    with pytest.raises(ValueError):
        jax_chain(jnp.asarray(x).astype(jdt), _jax_steps(steps), [jside])
    xt, s = torch.from_numpy(x).to(tdt), torch.from_numpy(sides[0]).to(side_dt)
    assert chain_dtype(tdt, tuple(steps), (side_dt,)) == torch.float32
    with pytest.raises(ValueError, match="chain's value"):
        dispatch.fused_chain(xt, steps, [s])


def test_a_narrower_side_in_an_f32_chain_is_promoted():
    """An f32 chain with a bf16 side: the side promotes (exactly), the value
    stays f32, as in JAX."""
    x, sides = _inputs(3)
    xt = torch.from_numpy(x)
    s = torch.from_numpy(sides[0]).to(torch.bfloat16)
    steps = [Step("mul", side=0), Step("exp")]
    got = dispatch.fused_chain(xt, steps, [s])
    want = jax_chain(jnp.asarray(x), _jax_steps(steps),
                     [jnp.asarray(s.float().numpy()).astype(jnp.bfloat16)])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)


# -- int32 chains: JAX computes those that keep integers, raises on the rest --

INT_CHAINS = [
    ("add_mul_neg_abs_relu_sqr", [Step("add", side=0), Step("mul", side=1), Step("neg"),
                                  Step("abs"), Step("sqr"), Step("relu")]),
    ("scale_add_scalar_sub_max2", [Step("scale", 3), Step("add_scalar", -7),
                                   Step("sub", side=0), Step("max2", side=1)]),
    ("wraps", [Step("scale", 65537), Step("sqr"), Step("add_scalar", 2 ** 31 - 1)]),
]
INT_RAISE = [("exp", [Step("exp")]), ("div", [Step("div", side=0)]),
             ("recip", [Step("recip")]), ("float_scale", [Step("scale", 2.0)]),
             ("sigmoid", [Step("sigmoid")]), ("sqrt", [Step("sqrt")])]


def _int_inputs():
    rng = np.random.default_rng(4)
    x = rng.integers(-50_000, 50_000, SHAPE).astype(np.int32)
    sides = [rng.integers(-9, 10, SHAPE).astype(np.int32) for _ in range(2)]
    return x, sides


@pytest.mark.parametrize("label,steps", INT_CHAINS, ids=[c[0] for c in INT_CHAINS])
def test_int32_chain_equals_jax(label, steps):
    """JAX's kernel computes an int32 chain whose every step keeps integers;
    the port's chain computes the same integers (wrapping as jnp does)."""
    x, sides = _int_inputs()
    xt = torch.from_numpy(x)
    st = [torch.from_numpy(s) for s in sides]
    got = dispatch.fused_chain(xt, steps, st)
    want = jax_chain(jnp.asarray(x), _jax_steps(steps),
                     [jnp.asarray(s.numpy()) for s in _jax_sides(steps, st)])
    assert got.dtype == torch.int32 and want.dtype == jnp.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("label,steps", INT_RAISE, ids=[c[0] for c in INT_RAISE])
def test_int32_chain_that_turns_float_raises_as_jax_does(label, steps):
    x, sides = _int_inputs()
    n_sides = sum(st.op == "div" for st in steps)
    with pytest.raises((ValueError, TypeError)):
        jax_chain(jnp.asarray(x), _jax_steps(steps), [jnp.asarray(sides[0])] * n_sides)
    with pytest.raises(ValueError, match="chain's value"):
        dispatch.fused_chain(torch.from_numpy(x), steps,
                             [torch.from_numpy(sides[0])] * n_sides)


def test_check_dtype_and_vectors():
    x = torch.zeros(4, dtype=torch.bfloat16)
    check_dtype(x, [Step("exp"), Step("gelu")], [])
    with pytest.raises(ValueError):
        check_dtype(torch.zeros(4, dtype=torch.int32), [Step("tanh")], [])
    assert [vec_of(t) for t in (torch.float32, torch.bfloat16, torch.float16, torch.int32)] \
        == [4, 8, 8, 4]


# -- a bf16 graph through both ComputeGraphs -----------------------------------

def _graph(pkg, d=64):
    """An elementwise bf16 graph: two chains, exp(0.5 x) * s then tanh then
    silu then + s, and (s - x)^2 through gelu."""
    x, s = pkg.var("x", (SHAPE[0], d)), pkg.var("s", (SHAPE[0], d))
    a = x.scale(0.5).exp().mul(s).tanh().silu().add(s)
    b = s.sub(x).sqr().gelu()
    return [a, b]


def test_bf16_graph_matches_jax_within_ulps():
    rng = np.random.default_rng(5)
    x = rng.uniform(-2, 2, (SHAPE[0], 64)).astype(np.float32)
    s = rng.uniform(0.5, 1.5, (SHAPE[0], 64)).astype(np.float32)
    xb, sb = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(s).to(torch.bfloat16)
    g_port = tgraph.ComputeGraph(_graph(tgraph), device="cpu")
    assert [[n.op.value for n in c.nodes] for c in g_port.fusion.chains] == [
        ["scale", "exp", "mul", "tanh", "silu", "add"], ["sub", "sqr", "gelu"]]
    global_profile.reset()
    got = g_port.run(x=xb, s=sb)
    assert global_profile.tier_summary()["fused_chain_bf16"] == {"ref": 2}
    g_jax = jgraph.ComputeGraph(_graph(jgraph))
    want = g_jax.run(x=jnp.asarray(x).astype(jnp.bfloat16), s=jnp.asarray(s).astype(jnp.bfloat16))
    for gi, wi in zip(got, want):
        assert gi.dtype == torch.bfloat16 and wi.dtype == jnp.bfloat16
        ok, worst = within_ulps(gi.float().numpy(), np.asarray(wi.astype(jnp.float32)),
                                torch.bfloat16, CHAIN_ULPS)
        assert ok, f"{worst:.2f} ulps from JAX"
    unfused = tgraph.ComputeGraph(_graph(tgraph), fuse=False, device="cpu").run(x=xb, s=sb)
    for gi, ui in zip(got, unfused):
        assert torch.equal(gi, ui)
