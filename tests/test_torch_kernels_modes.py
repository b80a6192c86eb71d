"""The kernel modes of the last JAX kernel functions, on the card (skipped
without one): K7 with its phase E (ZGML_TPU_LAYER_FFN), K6a's no-norm form,
the fused FFN's backward (ops/ffn.FusedFFN) and K13 on bf16 / f16 / int32
chains.

    python -m pytest --noconftest -q tests/test_torch_kernels_modes.py

(tests/conftest.py imports jax, which the card's machine need not have.)
"""
import numpy as np
import pytest
import torch

from zgml_tpu_torch.ops import dispatch, refs
from zgml_tpu_torch.ops.elementwise import Step, fused_chain_cuda, fused_chain_ref
from zgml_tpu_torch.ops.ffn import fused_ffn_cuda, fused_ffn_norm_cuda, fused_ffn_ref
from zgml_tpu_torch.ops.layerkernel import attn_block_cuda, attn_block_ffn_ref
from zgml_tpu_torch.quant.packed import from_int8, from_nibbles
from zgml_tpu_torch.runtime.profile import global_profile

pytestmark = pytest.mark.gpu
REL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _weight(rng, n, k, device, kind="q4_0"):
    d = rng.uniform(0.001, 0.02, (n, k // 32)).astype(np.float16)
    if kind == "q8_0":
        return from_int8(rng.integers(-127, 128, (n, k), dtype=np.int8), d / 16, device)
    return from_nibbles(rng.integers(0, 16, (n, k), dtype=np.uint8), d, device)


def _close(got, want, rtol=REL):
    assert bool(torch.isfinite(got).all())
    err = float((got - want).abs().max())
    assert err <= rtol * float(want.abs().max()), err


# -- K7 with phase E ------------------------------------------------------------

E_CASES = [(32, 4, 64, 5632, 2048, 0, 3),      # TinyLlama-1.1B widths, pos 0
           (32, 4, 64, 5632, 2048, 300, 1),    # three chunks live
           (32, 4, 64, 5632, 2048, 2047, 0),
           (32, 32, 128, 11008, 512, 257, 1),  # Llama-2-7B widths (MHA, hd 128)
           (8, 2, 32, 768, 96, 37, 1)]          # a small model


def _cache(rng, shape, kv8, device):
    if kv8:
        return (torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8)).to(device),
                torch.from_numpy(rng.uniform(0.01, 0.02, shape[:-1]).astype(np.float32)).to(
                    device))
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        device, torch.bfloat16)


def _clone(c):
    return tuple(t.clone() for t in c) if isinstance(c, tuple) else c.clone()


def _equal(a, b):
    if isinstance(a, tuple):
        return all(torch.equal(u, v) for u, v in zip(a, b))
    return torch.equal(a, b)


@pytest.mark.parametrize("a_i8,kv8", [(False, False), (False, True), (True, False),
                                      (True, True)], ids=["f32", "kv8", "i8", "i8_kv8"])
@pytest.mark.parametrize("hq,hkv,hd,f,s,pos,li", E_CASES)
def test_attn_block_ffn_is_the_chain_bit_for_bit(cuda, hq, hkv, hd, f, s, pos, li, a_i8, kv8):
    """K7-with-E equals the chain K7 (same A phase and cache) then K6d at
    one row bit for bit: x_out, k_cur, v_cur and the cache; a second launch
    gives the same bits; the f32 mode within REL of its plain chain."""
    rng = np.random.default_rng(pos + hd + 7 * a_i8 + 3 * kv8)
    d, L = hq * hd, li + 1
    wqkv, wo = _weight(rng, (hq + 2 * hkv) * hd, d, cuda), _weight(rng, d, hq * hd, cuda)
    gu, wd = _weight(rng, 2 * f, d, cuda), _weight(rng, d, f, cuda)
    g1, g2 = (torch.from_numpy((1 + 0.1 * rng.standard_normal(d)).astype(np.float32)).to(cuda)
              for _ in range(2))
    x = torch.from_numpy(rng.standard_normal((1, 1, d)).astype(np.float32)).to(cuda)
    ck, cv = (_cache(rng, (L, 1, hkv, s, hd), kv8, cuda) for _ in range(2))
    cos, sin = refs.rope_cos_sin(torch.tensor([pos], device=cuda), hd)
    pos_t = torch.tensor([pos], dtype=torch.int32, device=cuda)
    ck1, cv1, ck2, cv2, ck3, cv3 = (_clone(c) for c in (ck, cv, ck, cv, ck, cv))
    got = attn_block_cuda(x, g1, wqkv, wo, ck1, cv1, li, pos_t, cos, sin, hq, hkv, 1e-5, a_i8,
                          ffn=(g2, gu, wd))
    again = attn_block_cuda(x, g1, wqkv, wo, ck3, cv3, li, pos_t, cos, sin, hq, hkv, 1e-5, a_i8,
                            ffn=(g2, gu, wd))
    x2, k, v = attn_block_cuda(x, g1, wqkv, wo, ck2, cv2, li, pos_t, cos, sin, hq, hkv, 1e-5,
                               a_i8)
    chain = fused_ffn_norm_cuda(x2, g2, gu, wd, 1e-5, False)
    torch.cuda.synchronize()
    for a, b, c in zip(got, (chain, k, v), again):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert _equal(ck1, ck2) and _equal(cv1, cv2) and _equal(ck1, ck3)
    if not a_i8 and not kv8:
        want = attn_block_ffn_ref(x, g1, wqkv, wo, ck, cv, li, pos, cos, sin, hq, hkv, 1e-5,
                                  (g2, gu, wd))
        for a, b in zip(got, want):
            _close(a, b)


def test_attn_block_dispatch_places_phase_e(cuda):
    """dispatch.attn_block with ffn counts attn_block_ffn on the card."""
    rng = np.random.default_rng(1)
    hq, hkv, hd, f, s = 8, 2, 64, 1024, 64
    d = hq * hd
    wqkv, wo = _weight(rng, (hq + 2 * hkv) * hd, d, cuda), _weight(rng, d, hq * hd, cuda)
    gu, wd = _weight(rng, 2 * f, d, cuda), _weight(rng, d, f, cuda)
    g = torch.ones(d, device=cuda)
    ck, cv = (_cache(rng, (1, 1, hkv, s, hd), False, cuda) for _ in range(2))
    cos, sin = refs.rope_cos_sin(torch.tensor([5], device=cuda), hd)
    global_profile.reset()
    dispatch.attn_block(torch.ones((1, 1, d), device=cuda), g, wqkv, wo, ck, cv, 0,
                        torch.tensor([5], dtype=torch.int32, device=cuda), cos, sin, hq, hkv,
                        1e-5, (g, gu, wd))
    torch.cuda.synchronize()
    assert global_profile.tier_summary() == {"attn_block_ffn": {"cuda": 1}}


# -- K6a's no-norm form and the fused FFN's backward --------------------------------

@pytest.mark.parametrize("d,f,m", [(2048, 5632, 1), (2048, 5632, 8), (2048, 5632, 32),
                                   (512, 1024, 5), (4096, 11008, 3)])
def test_fused_ffn_q8_nonorm(cuda, d, f, m):
    """K6a without norm or residual (fused_ffn_cuda at Q8_0): within REL of
    fused_ffn_ref, two launches bit-equal."""
    rng = np.random.default_rng(m + d)
    gu, wd = _weight(rng, 2 * f, d, cuda, "q8_0"), _weight(rng, d, f, cuda, "q8_0")
    h = torch.from_numpy(rng.standard_normal((1, m, d)).astype(np.float32)).to(cuda)
    got, again = fused_ffn_cuda(h, gu, wd), fused_ffn_cuda(h, gu, wd)
    torch.cuda.synchronize()
    _close(got, fused_ffn_ref(h, gu, wd))
    assert torch.equal(got, again)


def _ffn_dx(h, g, gu, wd):
    leaf = h.detach().clone().requires_grad_()
    (dx,) = torch.autograd.grad(dispatch.fused_ffn(leaf, gu, wd), leaf, g)
    return dx


@pytest.mark.parametrize("kind", ["q4_0", "q8_0"])
@pytest.mark.parametrize("m", [1, 8, 32])
def test_fused_ffn_dx_against_force_ref(cuda, monkeypatch, kind, m):
    """The fused FFN's dx on the card (K6b / K6a no-norm forward, K1's
    recompute at <= 32 rows under ZGML_TPU_I8DOT, K11 twice) against the
    same Function under force_ref(), within max(REL * max|dx|, 2 x the plain
    version's own move when h moves by 1e-7 relative): the recompute's int8
    activations flip where the two sum the row in another order."""
    monkeypatch.delenv("ZGML_TPU_I8DOT", raising=False)
    rng = np.random.default_rng(m + 50 * (kind == "q8_0"))
    d, f = 2048, 5632
    gu, wd = _weight(rng, 2 * f, d, cuda, kind), _weight(rng, d, f, cuda, kind)
    h = torch.from_numpy(rng.standard_normal((1, m, d)).astype(np.float32)).to(cuda)
    g = torch.from_numpy(rng.standard_normal((1, m, d)).astype(np.float32)).to(cuda)
    global_profile.reset()
    dx = _ffn_dx(h, g, gu, wd)
    torch.cuda.synchronize()
    tiers = global_profile.tier_summary()
    sfx = "" if kind == "q4_0" else "_q8"
    assert tiers == {f"fused_ffn{sfx}": {"cuda": 1}, f"qmatmul_i8{sfx}": {"cuda": 1},
                     f"qmatmul_bwd{sfx}": {"cuda": 2}}, tiers
    with dispatch.force_ref():
        want = _ffn_dx(h, g, gu, wd)
        gen = torch.Generator(device=cuda).manual_seed(0)
        moved = max(float((_ffn_dx(h * (1 + 1e-7 * torch.randn(h.shape, device=cuda,
                                                                generator=gen)), g, gu, wd)
                           - want).abs().max()) for _ in range(3))
    err = float((dx - want).abs().max())
    assert err <= max(REL * float(want.abs().max()), 2 * moved), (err, moved)


# -- K13 on bf16 / f16 / int32 chains ------------------------------------------------

def _ulps(got, want):
    """|got - want| in units in the last place of the dtype at max(|got|, |want|)."""
    bits = 8 if got.dtype == torch.bfloat16 else 11
    a, b = got.double(), want.double()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    spacing = torch.ldexp(torch.ones_like(a), (e - bits).to(torch.int32))
    tiny = 2.0 ** -133 if got.dtype == torch.bfloat16 else 2.0 ** -24
    return float(((a - b).abs() / spacing.clamp_min(tiny)).max())


CHAINS_16 = [[Step("exp"), Step("mul", side=0), Step("tanh"), Step("silu"), Step("add", side=1)],
             [Step("scale", 1.7), Step("gelu"), Step("sub", side=0, side_left=True)],
             [Step("sigmoid"), Step("div", side=0), Step("add_scalar", 0.3), Step("sqrt"),
              Step("log"), Step("recip"), Step("neg"), Step("abs"), Step("relu"),
              Step("max2", side=1), Step("sqr")]]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("shape,side_shapes", [((512, 5632), ((512, 5632), (512, 5632))),
                                               ((256, 2048), ((2048,), (256, 1))),
                                               ((4099,), ((4099,), (1,)))])
def test_fused_chain_16_bit(cuda, dtype, shape, side_shapes):
    """K13's bf16 / f16 form within 1 ulp per element of its plain version,
    two launches bit-equal; sides read in place (a bias, a row scalar) and a
    ragged length."""
    g = torch.Generator(device=cuda).manual_seed(len(shape))
    x = (torch.rand(shape, device=cuda, generator=g) * 4 - 2).to(dtype)
    sides = [(0.5 + torch.rand(s, device=cuda, generator=g)).to(dtype) for s in side_shapes]
    for steps in CHAINS_16:
        got, again = fused_chain_cuda(x, steps, sides), fused_chain_cuda(x, steps, sides)
        want = fused_chain_ref(x, steps, sides)
        torch.cuda.synchronize()
        assert got.dtype == dtype and torch.equal(got, again)
        fin = torch.isfinite(want)
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.equal(got[want.isinf()], want[want.isinf()])
        assert _ulps(got[fin], want[fin]) <= 1, steps


def test_fused_chain_int32(cuda):
    """An int32 chain of the ops that keep integers equals the plain chain
    (wrapping as torch does); one that turns float raises."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randint(-2 ** 31, 2 ** 31 - 1, (1000, 37), device=cuda, generator=g,
                      dtype=torch.int32)
    s = torch.randint(-9, 10, (37,), device=cuda, generator=g, dtype=torch.int32)
    steps = [Step("scale", 65537), Step("add", side=0), Step("sqr"), Step("neg"), Step("abs"),
             Step("sub", side=0, side_left=True), Step("max2", side=0), Step("relu"),
             Step("add_scalar", 7), Step("mul", side=0)]
    assert torch.equal(fused_chain_cuda(x, steps, [s]), fused_chain_ref(x, steps, [s]))
    with pytest.raises(ValueError, match="chain's value"):
        fused_chain_cuda(x, [Step("exp")], [])
