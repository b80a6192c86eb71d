"""K2, K1 and K5 at Q4_0 and Q8_0: the port's packed weight and plain versions
against the JAX package.

The JAX side quantizes with f16 block scales (bit-exact to GGUF) and runs
qmatmul_pallas in interpret mode. On its f32-dequant tier (ZGML_TPU_I8DOT=0,
f32 operands at every M) the port's K2 plain version must agree within
rtol 1e-5 / atol 1e-4 * sqrt(K) at Q4_0 and 1e-5 * max|y| at Q8_0: f32 sums
taken in another order. On its int8-activation tier (the default, M <= 32)
the port's K1 plain version must quantize the activations to the same int8
values and scales bit for bit and agree within 1e-5 * max|y| (exact integer
block dots; only the f32 sum over blocks differs), and K5 must give the same
id wherever the top-2 gap exceeds that bound. The port's weights (converted
from the JAX layout, loaded from GGUF bytes, or quantized by the port) must
dequantize to the JAX package's values bit for bit.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zgml_tpu.ops.qmatmul import _quantize_act, qmatmul_greedy_pallas, qmatmul_pallas
from zgml_tpu.quant.repack import dequant_packed, quantize_weight, repack_gguf_tensor

from zgml_tpu_torch.io import llama_loader
from zgml_tpu_torch.ops import dispatch
from zgml_tpu_torch.ops.qmatmul import qmatmul_i8_ref, qmatmul_ref, quantize_act_ref
from zgml_tpu_torch.quant import blocks, packed
from zgml_tpu_torch.runtime.profile import global_profile

torch.set_num_threads(1)

N, K = 384, 512


@pytest.fixture
def slice_flags(monkeypatch):
    monkeypatch.setenv("ZGML_TPU_SCALES", "f16")
    monkeypatch.setenv("ZGML_TPU_I8DOT", "0")
    monkeypatch.setenv("ZGML_TPU_PREFILL_BF16", "0")


@pytest.fixture
def default_flags(monkeypatch):
    """The JAX package's default tiers (int8 activations for M <= 32), with
    f16 scales so both packages hold the GGUF scales exactly."""
    monkeypatch.setenv("ZGML_TPU_SCALES", "f16")
    monkeypatch.delenv("ZGML_TPU_I8DOT", raising=False)


def _jax_weight(jpw):
    return dataclasses.replace(jpw, qvals=jnp.asarray(jpw.qvals), scales=jnp.asarray(jpw.scales))


_FROM_PLANAR = {"q4_0": packed.from_planar_q4_0, "q8_0": packed.from_planar_q8_0}


def _weights(seed, n=N, k=K, kind="q4_0"):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, k)).astype(np.float32)
    jpw = quantize_weight(w, kind)
    pw = _FROM_PLANAR[kind](jpw.qvals, jpw.scales, jpw.n, jpw.k, device="cpu")
    assert pw.kind == kind
    return rng, jpw, pw


def _bit_equal(got: np.ndarray, want: np.ndarray) -> bool:
    return got.shape == want.shape and np.array_equal(got.view(np.uint32), want.view(np.uint32))


def _check_converted(kind):
    _, jpw, pw = _weights(0, kind=kind)
    assert jpw.scales.dtype == np.int16            # f16 bit patterns
    assert pw.dequant().shape == (N, K)
    assert _bit_equal(pw.dequant().numpy(), dequant_packed(jpw))


def test_converted_weight_dequant_is_bit_exact(slice_flags):
    _check_converted("q4_0")


def test_q8_converted_weight_dequant_is_bit_exact(slice_flags):
    _check_converted("q8_0")


def _check_gguf_bytes(kind):
    """Raw GGUF blocks -> PackedWeight -> dequant equals the codec's dequant
    and the JAX package's repacked weight."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((96, 256)).astype(np.float32)
    raw = getattr(blocks, f"quantize_{kind}")(w)
    pw = getattr(packed, f"from_gguf_{kind}")(raw, 96, 256, device="cpu")
    got = pw.dequant().numpy()
    assert np.array_equal(got, getattr(blocks, f"dequantize_{kind}")(raw, w.size).reshape(96, 256))
    assert _bit_equal(got, dequant_packed(repack_gguf_tensor(kind, raw, 96, 256)))


def test_gguf_bytes_load_bit_exact(slice_flags):
    _check_gguf_bytes("q4_0")


def test_q8_gguf_bytes_load_bit_exact(slice_flags):
    _check_gguf_bytes("q8_0")


@pytest.mark.parametrize("kind", ["q4_0", "q8_0"])
def test_quantize_weight_matches_jax(slice_flags, kind):
    """The loader's quantize_weight writes the JAX package's values."""
    w = np.random.default_rng(2).standard_normal((64, 192)).astype(np.float32)
    pw = llama_loader.quantize_weight(w, kind, device="cpu")
    assert pw.kind == kind and (pw.n, pw.k) == (64, 192)
    assert _bit_equal(pw.dequant().numpy(), dequant_packed(quantize_weight(w, kind)))


def _matmul_pair(seed, m, kind):
    """(port plain output, JAX kernel output) on the same x and weight; the
    port side's placement counts are reset first."""
    rng, jpw, pw = _weights(seed, kind=kind)
    x = rng.standard_normal((m, K)).astype(np.float32)
    want = np.asarray(qmatmul_pallas(jnp.asarray(x), _jax_weight(jpw)))
    global_profile.reset()
    got = dispatch.qmatmul(torch.from_numpy(x), pw).numpy()
    assert got.shape == want.shape == (m, N)
    return x, got, want


@pytest.mark.parametrize("m", [1, 5, 32, 40])
def test_q4_matmul_plain_matches_jax_kernel(slice_flags, m):
    _, got, want = _matmul_pair(10 + m, m, "q4_0")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4 * np.sqrt(K))


@pytest.mark.parametrize("m", [1, 3, 64])
def test_q8_matmul_plain_matches_jax_kernel(slice_flags, m):
    """K2q8's plain version against `_q8_matmul` (f32 dequant, f32 sums)."""
    _, got, want = _matmul_pair(50 + m, m, "q8_0")
    assert global_profile.tier_summary() == {"qmatmul_q8": {"ref": 1}}
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))


def test_q4_matmul_keeps_leading_dims(slice_flags):
    rng, _, pw = _weights(3)
    x = torch.from_numpy(rng.standard_normal((2, 3, K)).astype(np.float32))
    y = dispatch.qmatmul(x, pw)
    assert y.shape == (2, 3, N)
    torch.testing.assert_close(y.reshape(6, N), qmatmul_ref(x.reshape(6, K), pw))


def test_concat_keeps_part_order():
    rng = np.random.default_rng(4)
    parts = [packed.from_nibbles(rng.integers(0, 16, (n, 64), dtype=np.uint8),
                                 rng.uniform(0.1, 1, (n, 2)).astype(np.float16), "cpu")
             for n in (8, 16, 4)]
    cat = packed.concat(parts)
    assert (cat.n, cat.k) == (28, 64)
    assert torch.equal(cat.dequant(), torch.cat([p.dequant() for p in parts]))


def test_packed_weight_rejects_bad_planes():
    with pytest.raises(ValueError):
        packed.PackedWeight(4, 64, torch.zeros(4, 31, dtype=torch.uint8),
                            torch.zeros(4, 2, dtype=torch.float16))
    with pytest.raises(ValueError):
        packed.PackedWeight(4, 48, torch.zeros(4, 24, dtype=torch.uint8),
                            torch.zeros(4, 1, dtype=torch.float16))
    with pytest.raises(ValueError):          # Q8_0 holds one int8 per element
        packed.PackedWeight(4, 64, torch.zeros(4, 32, dtype=torch.int8),
                            torch.zeros(4, 2, dtype=torch.float16), "q8_0")
    with pytest.raises(ValueError):
        packed.PackedWeight(4, 64, torch.zeros(4, 64, dtype=torch.uint8),
                            torch.zeros(4, 2, dtype=torch.float16), "q8_0")
    with pytest.raises(ValueError):
        packed.PackedWeight(4, 64, torch.zeros(4, 64, dtype=torch.int8),
                            torch.zeros(4, 2, dtype=torch.float16), "q5_0")


def test_concat_refuses_mixed_kinds():
    q4 = packed.from_nibbles(np.zeros((4, 64), np.uint8), np.ones((4, 2), np.float16), "cpu")
    q8 = packed.from_int8(np.zeros((4, 64), np.int8), np.ones((4, 2), np.float16), "cpu")
    assert packed.concat([q8, q8]).kind == "q8_0"
    with pytest.raises(ValueError, match="mixed kinds"):
        packed.concat([q4, q8])


@pytest.mark.parametrize("m", [1, 5, 32])
def test_q4_i8_quantize_is_bit_exact_to_jax(m):
    rng = np.random.default_rng(20 + m)
    x = rng.standard_normal((m, K)).astype(np.float32)
    x[0, :32] = 0.0                                # an all-zero block: s = 0, inv = 0
    x[-1, 32:64] *= 1e-3
    jq, js = _quantize_act(jnp.asarray(x))
    q, s = quantize_act_ref(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy().view(np.uint32), np.asarray(js).view(np.uint32))


@pytest.mark.parametrize("m", [1, 5, 32])
def test_q4_matmul_i8_plain_matches_jax_kernel(default_flags, m):
    _, got, want = _matmul_pair(30 + m, m, "q4_0")
    assert global_profile.tier_summary() == {"qmatmul_i8": {"ref": 1}}
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))


@pytest.mark.parametrize("m", [1, 8, 32])
def test_q8_matmul_i8_plain_matches_jax_kernel(default_flags, m):
    """K1q8's plain version against `_q8_matmul_i8`: the same int8
    activations and scales bit for bit, outputs within 1e-5 * max|y|."""
    x, got, want = _matmul_pair(60 + m, m, "q8_0")
    assert global_profile.tier_summary() == {"qmatmul_i8_q8": {"ref": 1}}
    jq, js = _quantize_act(jnp.asarray(x))
    q, s = quantize_act_ref(torch.from_numpy(x))
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert _bit_equal(s.numpy(), np.asarray(js))
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))


def test_q4_matmul_i8_keeps_leading_dims(default_flags):
    rng, _, pw = _weights(3)
    x = torch.from_numpy(rng.standard_normal((2, 3, K)).astype(np.float32))
    y = dispatch.qmatmul(x, pw)
    assert y.shape == (2, 3, N)
    torch.testing.assert_close(y.reshape(6, N), qmatmul_i8_ref(x.reshape(6, K), pw))


def test_qmatmul_tier_follows_rows_and_flag(default_flags, monkeypatch):
    """K1 for M <= 32 (or tier_rows <= 32), K2 above, K2 everywhere with
    ZGML_TPU_I8DOT=0 (zgml_tpu/ops/qmatmul.py:639,728); K2 in its bf16 form
    where JAX's row tile holds 32 rows or more (the 33-row call and the row
    at tier_rows 128, under the default ZGML_TPU_PREFILL_BF16), f32 below."""
    rng, _, pw = _weights(7)
    x33 = torch.from_numpy(rng.standard_normal((33, K)).astype(np.float32))
    global_profile.reset()
    dispatch.qmatmul(x33[:32], pw)
    dispatch.qmatmul(x33, pw)
    dispatch.qmatmul(x33[:1], pw, tier_rows=128)
    dispatch.qmatmul(x33[:1], pw, tier_rows=16)
    monkeypatch.setenv("ZGML_TPU_I8DOT", "0")
    dispatch.qmatmul(x33[:1], pw)
    assert global_profile.tier_summary() == {"qmatmul": {"ref": 1}, "qmatmul_bf16": {"ref": 2},
                                             "qmatmul_i8": {"ref": 2}}


def _check_greedy(seed, kind):
    rng, jpw, pw = _weights(seed, kind=kind)
    x = rng.standard_normal((1, K)).astype(np.float32)
    y = np.asarray(qmatmul_pallas(jnp.asarray(x), _jax_weight(jpw)))[0]
    want = int(np.asarray(qmatmul_greedy_pallas(jnp.asarray(x), _jax_weight(jpw)))[0])
    assert want == int(np.argmax(y))               # the JAX kernel's own contract
    got = dispatch.qmatmul_greedy(torch.from_numpy(x), pw)
    assert got.dtype == torch.int64 and got.shape == (1,)
    top2 = np.sort(y)[-2:]
    if top2[1] - top2[0] > 1e-5 * np.max(np.abs(y)):
        assert int(got[0]) == want
    # K5's plain version is argmax of K1's plain version, first index on ties
    assert int(got[0]) == int(torch.argmax(dispatch.qmatmul(torch.from_numpy(x), pw)[0]))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_q4_greedy_plain_matches_jax_kernel(default_flags, seed):
    _check_greedy(40 + seed, "q4_0")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_q8_greedy_plain_matches_jax_kernel(default_flags, seed):
    """K5q8's plain version against `_q8_i8_argmax_kernel`, and its placement
    count under qmatmul_greedy_q8."""
    global_profile.reset()
    _check_greedy(70 + seed, "q8_0")
    assert global_profile.tier_summary()["qmatmul_greedy_q8"] == {"ref": 1}


def test_q4_greedy_takes_one_row_and_the_int8_tier(default_flags, monkeypatch):
    _, _, pw = _weights(9)
    assert dispatch.qmatmul_greedy(torch.zeros(2, K), pw) is None
    monkeypatch.setenv("ZGML_TPU_I8DOT", "0")
    assert dispatch.qmatmul_greedy(torch.zeros(1, K), pw) is None


# -- K11: dx = g @ dequant(W), the backward of a frozen quantized projection --

@pytest.mark.parametrize("kind,k,n,m", [
    ("q8_0", 512, 384, 16),
    ("q4_0", 512, 384, 16),
    ("q4_0", 768, 256, 40),   # odd m (the JAX pad path), k not a multiple of 512
])
def test_qmatmul_grad_matches_jax_grad(slice_flags, kind, k, n, m):
    """dx of dispatch.qmatmul under autograd (QMatmul: K2's plain forward,
    K11's plain backward) against jax.grad of qmatmul_pallas (K11q4 / K11q8
    in interpret mode) at tests/test_vjp.py's cases: within 1e-5 * max|dx|
    (f32 sums in another order); the weight gets no gradient."""
    import jax
    rng = np.random.default_rng(hash((kind, k, n, m)) % 2**32)
    w = rng.standard_normal((n, k)).astype(np.float32)
    jpw = quantize_weight(w, kind)
    pw = _FROM_PLANAR[kind](jpw.qvals, jpw.scales, jpw.n, jpw.k, device="cpu")
    x = rng.standard_normal((m, k)).astype(np.float32)
    g = rng.standard_normal((m, n)).astype(np.float32)
    jg = jnp.asarray(g)
    want = np.asarray(jax.grad(lambda x_: jnp.sum(qmatmul_pallas(x_, _jax_weight(jpw)) * jg))(
        jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_()
    global_profile.reset()
    torch.sum(dispatch.qmatmul(tx, pw) * torch.from_numpy(g)).backward()
    name = "qmatmul" if kind == "q4_0" else "qmatmul_q8"
    assert global_profile.tier_summary() == {name: {"ref": 1},
                                             name.replace("qmatmul", "qmatmul_bwd"): {"ref": 1}}
    assert not pw.qs.requires_grad and not pw.d.requires_grad
    err = np.max(np.abs(tx.grad.numpy() - want))
    assert err <= 1e-5 * np.max(np.abs(want)), err


@pytest.mark.parametrize("kind", ["q4_0", "q8_0"])
@pytest.mark.parametrize("m", [1, 8, 32])
def test_qmatmul_grad_on_the_int8_tier_is_straight_through(default_flags, kind, m):
    """At M <= 32 the forward is K1 (int8 activations), whose plain version
    rounds: autograd through it would give a zero dx. QMatmul's backward is
    K11 there too, dx = g @ dequant(W), as JAX's `_qmm_diff_bwd`."""
    rng, _, pw = _weights(70 + m, kind=kind)
    x = torch.from_numpy(rng.standard_normal((1, m, K)).astype(np.float32)).requires_grad_()
    g = torch.from_numpy(rng.standard_normal((1, m, N)).astype(np.float32))
    global_profile.reset()
    y = dispatch.qmatmul(x, pw)
    torch.sum(y * g).backward()
    tiers = global_profile.tier_summary()
    sfx = "" if kind == "q4_0" else "_q8"
    assert tiers == {f"qmatmul_i8{sfx}": {"ref": 1}, f"qmatmul_bwd{sfx}": {"ref": 1}}, tiers
    with torch.no_grad():
        np.testing.assert_array_equal(y.numpy(), qmatmul_i8_ref(x, pw).numpy())
    want = (g.reshape(m, N) @ pw.dequant()).reshape(1, m, K)
    assert x.grad.shape == x.shape
    np.testing.assert_array_equal(x.grad.numpy(), want.numpy())
