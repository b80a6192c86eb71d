"""K2, K1 and K5: the port's packed weight and plain versions against the JAX package.

The JAX side quantizes with f16 block scales (bit-exact to GGUF) and runs
qmatmul_pallas in interpret mode. On its f32-dequant tier (ZGML_TPU_I8DOT=0,
f32 operands at every M) the port's K2 plain version must agree within
rtol 1e-5 / atol 1e-4 * sqrt(K): f32 sums taken in another order. On its
int8-activation tier (the default, M <= 32) the port's K1 plain version must
quantize the activations to the same int8 values and scales bit for bit and
agree within 1e-5 * max|y| (exact integer block dots; only the f32 sum over
blocks differs), and K5 must give the same id wherever the top-2 gap exceeds
that bound. The port's converted weight must dequantize to the same values
bit for bit.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zgml_tpu.ops.qmatmul import _quantize_act, qmatmul_greedy_pallas, qmatmul_pallas
from zgml_tpu.quant.repack import dequant_packed, quantize_weight

from zgml_tpu_torch.ops import dispatch
from zgml_tpu_torch.ops.qmatmul import q4_matmul_i8_ref, q4_matmul_ref, quantize_act_ref
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


def _weights(seed, n=N, k=K):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, k)).astype(np.float32)
    jpw = quantize_weight(w, "q4_0")
    pw = packed.from_planar_q4_0(jpw.qvals, jpw.scales, jpw.n, jpw.k)
    return rng, jpw, pw


def test_converted_weight_dequant_is_bit_exact(slice_flags):
    _, jpw, pw = _weights(0)
    assert jpw.scales.dtype == np.int16            # f16 bit patterns
    want = dequant_packed(jpw)
    got = pw.dequant().numpy()
    assert got.shape == want.shape == (N, K)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_gguf_bytes_load_bit_exact():
    """Raw GGUF blocks -> PackedWeight -> dequant equals the codec's dequant."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((96, 256)).astype(np.float32)
    raw = blocks.quantize_q4_0(w)
    pw = packed.from_gguf_q4_0(raw, 96, 256)
    want = blocks.dequantize_q4_0(raw, w.size).reshape(96, 256)
    assert np.array_equal(pw.dequant().numpy(), want)


@pytest.mark.parametrize("m", [1, 5, 32, 40])
def test_q4_matmul_plain_matches_jax_kernel(slice_flags, m):
    rng, jpw, pw = _weights(10 + m)
    x = rng.standard_normal((m, K)).astype(np.float32)
    jpw_dev = dataclasses.replace(jpw, qvals=jnp.asarray(jpw.qvals),
                                  scales=jnp.asarray(jpw.scales))
    want = np.asarray(qmatmul_pallas(jnp.asarray(x), jpw_dev))
    got = dispatch.qmatmul(torch.from_numpy(x), pw).numpy()
    assert got.shape == want.shape == (m, N)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4 * np.sqrt(K))


def test_q4_matmul_keeps_leading_dims(slice_flags):
    rng, _, pw = _weights(3)
    x = torch.from_numpy(rng.standard_normal((2, 3, K)).astype(np.float32))
    y = dispatch.qmatmul(x, pw)
    assert y.shape == (2, 3, N)
    torch.testing.assert_close(y.reshape(6, N), q4_matmul_ref(x.reshape(6, K), pw))


def test_concat_keeps_part_order():
    rng = np.random.default_rng(4)
    parts = [packed.from_nibbles(rng.integers(0, 16, (n, 64), dtype=np.uint8),
                                 rng.uniform(0.1, 1, (n, 2)).astype(np.float16))
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
    rng, jpw, pw = _weights(30 + m)
    x = rng.standard_normal((m, K)).astype(np.float32)
    want = np.asarray(qmatmul_pallas(jnp.asarray(x), _jax_weight(jpw)))
    global_profile.reset()
    got = dispatch.qmatmul(torch.from_numpy(x), pw).numpy()
    assert global_profile.tier_summary() == {"qmatmul_i8": {"ref": 1}}
    assert got.shape == want.shape == (m, N)
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))


def test_q4_matmul_i8_keeps_leading_dims(default_flags):
    rng, _, pw = _weights(3)
    x = torch.from_numpy(rng.standard_normal((2, 3, K)).astype(np.float32))
    y = dispatch.qmatmul(x, pw)
    assert y.shape == (2, 3, N)
    torch.testing.assert_close(y.reshape(6, N), q4_matmul_i8_ref(x.reshape(6, K), pw))


def test_qmatmul_tier_follows_rows_and_flag(default_flags, monkeypatch):
    """K1 for M <= 32 (or tier_rows <= 32), K2 above, K2 everywhere with
    ZGML_TPU_I8DOT=0 (zgml_tpu/ops/qmatmul.py:639,728)."""
    rng, _, pw = _weights(7)
    x33 = torch.from_numpy(rng.standard_normal((33, K)).astype(np.float32))
    global_profile.reset()
    dispatch.qmatmul(x33[:32], pw)
    dispatch.qmatmul(x33, pw)
    dispatch.qmatmul(x33[:1], pw, tier_rows=128)
    dispatch.qmatmul(x33[:1], pw, tier_rows=16)
    monkeypatch.setenv("ZGML_TPU_I8DOT", "0")
    dispatch.qmatmul(x33[:1], pw)
    assert global_profile.tier_summary() == {"qmatmul": {"ref": 3}, "qmatmul_i8": {"ref": 2}}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_q4_greedy_plain_matches_jax_kernel(default_flags, seed):
    rng, jpw, pw = _weights(40 + seed)
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


def test_q4_greedy_takes_one_row_and_the_int8_tier(default_flags, monkeypatch):
    _, _, pw = _weights(9)
    assert dispatch.qmatmul_greedy(torch.zeros(2, K), pw) is None
    monkeypatch.setenv("ZGML_TPU_I8DOT", "0")
    assert dispatch.qmatmul_greedy(torch.zeros(1, K), pw) is None
