"""K11's design (csrc/qmatmul_bwd.cu, the quantized matmul's dx on TF32
tensor cores), held on the CPU before the card sees it. numpy only.

- The operands: every Q4_0 level (-8..7), every Q8_0 level (-127..127) and
  every finite fp16 scale is a TF32 value, so the levels go to the tensor
  cores as they are; level * scale is exact in f32 (the plain version's
  weight); g * scale splits into hi = tf32(fl32(g * scale)) and lo = the
  rest of the exact product in f32 (one fma), which the tensor cores read
  truncated to TF32: at most 2^-21 |g * scale| is left behind.
- The accumulation: an emulation of the kernel (g * scale split so, two
  m16n8k8 steps per 8 rows of N rounded toward zero as the tensor cores
  accumulate, fresh accumulators per stage of BWD_BN rows, lo products
  first, joined by a round-to-nearest add) stays within an f32 FMA loop's
  rms error against float64 at N 96 and at the TinyLlama-1.1B contraction
  lengths, where one chain over all of N in place is at least 3x worse.
- ``qmatmul_bwd_plan``: the parts cover every row of N exactly once, in
  whole stages, at the five TinyLlama shapes and at ragged N, for several
  SM counts.
"""
import numpy as np
import pytest

from zgml_tpu_torch.ops.qmatmul import BWD_BN, BWD_MAX_SPLIT, qmatmul_bwd_plan


def tf32_rn(x) -> np.ndarray:
    """f32 values rounded to TF32 (10 stored mantissa bits, to nearest, ties
    away from zero), as cvt.rna.tf32.f32 and the kernel's tf32_rna make them."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_trunc(x) -> np.ndarray:
    """f32 values as the tensor cores read a TF32 operand: the low 13 bits
    dropped (toward zero)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def split_product(g, d):
    """The kernel's operands for g * d (tf32_mma.cuh split_product): hi =
    tf32_rn(fl32(g * d)), lo = fl32(g * d - hi) as one fma rounds it (g * d -
    hi is exact in float64), read truncated to TF32."""
    g, d = np.asarray(g, np.float32), np.asarray(d, np.float32)
    hi = tf32_rn(g * d)
    lo = (g.astype(np.float64) * d.astype(np.float64) - hi.astype(np.float64)).astype(np.float32)
    return hi, tf32_trunc(lo)


def _rz(x64: np.ndarray) -> np.ndarray:
    """float64 -> float32 rounded toward zero."""
    f = x64.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x64)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _mma(acc, a, b):
    """One m16n8k8-style step: acc + a @ b with exact products, rounded
    toward zero to f32 as the tensor cores accumulate."""
    return _rz(acc.astype(np.float64) + a.astype(np.float64) @ b.astype(np.float64))


def _finite_fp16() -> np.ndarray:
    h = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16).view(np.float16)
    return h[np.isfinite(h)].astype(np.float32)


def test_levels_and_scales_are_tf32_and_the_split_of_g_times_scale_is_f32_class():
    q4 = np.arange(-8, 8, dtype=np.float32)
    q8 = np.arange(-127, 128, dtype=np.float32)
    scales = _finite_fp16()
    for x in (q4, q8, scales):
        assert np.array_equal(tf32_rn(x), x)
    rng = np.random.default_rng(0)
    d = rng.choice(scales, 100_000)
    for levels in (q4, q8):      # level * scale: exact in f32
        w64 = levels[:, None].astype(np.float64) * d[None, :].astype(np.float64)
        assert np.array_equal((levels[:, None] * d[None, :]).astype(np.float64), w64)
    # g * d as the kernel splits it: both parts TF32, at most 2^-21 |g * d| left
    g = (rng.standard_normal(100_000) * np.float32(2.0) ** rng.integers(-40, 20, 100_000)
         ).astype(np.float32)
    hi, lo = split_product(g, d)
    assert np.array_equal(tf32_rn(hi), hi) and np.array_equal(tf32_rn(lo), lo)
    exact = g.astype(np.float64) * d.astype(np.float64)
    resid = np.abs(exact - hi.astype(np.float64) - lo.astype(np.float64))
    assert np.all(resid <= 2.0 ** -21 * np.abs(exact))


def _tile(n: int, seed: int = 3):
    """g [16, n] f32, Q4_0 levels [n, 32] and fp16 scales [n] of one quant
    block of k: one 16 x 32 output tile of dx."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((16, n)).astype(np.float32)
    lev = rng.integers(-8, 8, (n, 32)).astype(np.float32)
    d = rng.uniform(0.001, 0.02, n).astype(np.float16).astype(np.float32)
    return g, lev, d


def _kernel_emulated(g, lev, d, form):
    """The kernel's dx tile: g * d split hi + lo, two MMA steps per 8 rows of
    N (lo first). "fresh": every BWD_BN rows into fresh accumulators
    joined by a round-to-nearest add (csrc/qmatmul_bwd.cu); "single": one
    chain over all of N in place."""
    hi, lo = split_product(g, d[None, :])
    acc = np.zeros((g.shape[0], lev.shape[1]), np.float32)
    for n0 in range(0, g.shape[1], BWD_BN):
        fr = np.zeros_like(acc) if form == "fresh" else acc
        for k0 in range(n0, min(n0 + BWD_BN, g.shape[1]), 8):
            fr = _mma(fr, lo[:, k0:k0 + 8], lev[k0:k0 + 8])
            fr = _mma(fr, hi[:, k0:k0 + 8], lev[k0:k0 + 8])
        acc = (acc + fr).astype(np.float32) if form == "fresh" else fr
    return acc


def _f32_loop(g, lev, d):
    """An f32 FMA loop over n (round to nearest): dx += g[:, n] * w[n]."""
    w = lev * d[:, None]
    acc = np.zeros((g.shape[0], lev.shape[1]), np.float32)
    for n in range(g.shape[1]):
        acc = (acc.astype(np.float64) + g[:, n:n + 1].astype(np.float64) * w[n]).astype(
            np.float32)
    return acc


def _errors(n: int) -> dict:
    """rms error against float64 of the emulated kernel ("fresh"), one chain
    in place ("single") and the f32 FMA loop, on one seeded tile."""
    g, lev, d = _tile(n)
    exact = g.astype(np.float64) @ (lev.astype(np.float64) * d[:, None].astype(np.float64))

    def rms(x):
        return float(np.sqrt(np.mean((x.astype(np.float64) - exact) ** 2)))
    return {"fresh": rms(_kernel_emulated(g, lev, d, "fresh")),
            "single": rms(_kernel_emulated(g, lev, d, "single")),
            "loop": rms(_f32_loop(g, lev, d))}


@pytest.mark.parametrize("n", [2048, 11264, 32000])
def test_accumulation_chains_keep_the_error_of_an_f32_loop(n):
    """At TinyLlama-1.1B's contraction lengths (wo / w_down, w_gate_up's dx
    over 2 x 5632, lm_head) the kernel's per-stage chains stay within an
    f32 FMA loop's rms error against float64; one chain in place does not."""
    e = _errors(n)
    assert e["fresh"] <= e["loop"], e
    assert e["single"] >= 3 * e["fresh"], e


def test_a_short_contraction_keeps_the_error_of_an_f32_loop():
    """N 96 (the GPU test's M 40 x N 96 case): 3 stages, where the round
    toward zero of each chain's MMAs weighs most against the f32 loop's 96
    round-to-nearest adds."""
    e = _errors(96)
    assert e["fresh"] <= e["loop"], e


TINY_SHAPES = [(2560, 2048), (2048, 2048), (11264, 2048), (2048, 5632), (32000, 2048)]


@pytest.mark.parametrize("sm_count,per_sm", [(132, 1), (132, 2), (114, 1), (16, 1), (1, 1)])
@pytest.mark.parametrize("m,n,k", [(512, n, k) for n, k in TINY_SHAPES] +
                         [(40, 96, 64), (1, 300, 576), (77, 1000, 512), (512, 33, 32),
                          (3, 31, 4096), (128, 257, 128)])
def test_plan_covers_every_row_once(m, n, k, sm_count, per_sm):
    plan = qmatmul_bwd_plan(m, n, k, sm_count, per_sm)
    assert 1 <= plan.n_split <= BWD_MAX_SPLIT and len(plan.parts) == plan.n_split
    covered = np.zeros(n, np.int64)
    for b, e in plan.parts:
        assert b < e and b % BWD_BN == 0
        covered[b:e] += 1
    assert np.all(covered == 1)
    assert plan.parts[0][0] == 0 and plan.parts[-1][1] == n


def test_plan_fills_the_h100_at_the_training_shapes():
    """132 SMs, one block each: the parts that fill whole waves."""
    got = [qmatmul_bwd_plan(512, n, k, 132).n_split for n, k in TINY_SHAPES]
    assert got == [2, 2, 2, 3, 2], got
