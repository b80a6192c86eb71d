"""K2's tiled design (csrc/qmatmul.cu, y = x @ dequant(W)^T on TF32 tensor
cores through `wgmma`), held on the CPU before the card sees it. numpy only.

- The operands: every Q4_0 level (-8..7) and Q8_0 level (-127..127) is a
  TF32 value and goes to the tensor cores as it is; x splits into hi =
  rna(x) and lo = rna(x - hi), both TF32, at most 2^-22 |x| left behind.
  The level tile is built from the raw block bytes with a byte permute and
  one subtract, in the 128-byte swizzle `wgmma` reads.
- The accumulation: an emulation of the kernel (per quant block of 32 k, 8
  MMAs of 8 k each, the 4 lo steps first, then the 4 hi ones, each rounded
  toward zero as the tensor cores accumulate, into a fresh accumulator that
  joins the running sum in one round-to-nearest fma with the block's scale;
  split-K parts added in order) stays within an f32 FMA loop's rms error
  against float64 at the TinyLlama-1.1B and Llama-2-7B contraction lengths,
  at both kinds. One chain in place over all of K (the scale folded into the
  weight, split in two TF32 parts, three MMAs a step) is at least 3x worse.
- ``qmatmul_plan``: the parts cover every quant block exactly once at the
  TinyLlama-1.1B and Llama-2-7B shapes, at ragged M and N and several SM
  counts; at 132 SMs the grid of a 128-row chunk fills the card.
"""
import numpy as np
import pytest

from test_torch_qmatmul_split import _rz, tf32_rn, tf32_trunc
from zgml_tpu_torch.ops.qmatmul import (FWD_BM, FWD_BN, FWD_MAX_SPLIT, FWD_MIN_STAGES,
                                        qmatmul_plan)

QK = 32
KINDS = ("q4_0", "q8_0")


def split_tf32(x):
    """x = hi + lo, both TF32 (tf32_mma.cuh split_tf32): hi = rna(x), lo =
    rna(x - hi); x - hi is exact in f32."""
    x = np.asarray(x, np.float32)
    hi = tf32_rn(x)
    return hi, tf32_rn(x - hi)


def test_x_splits_into_two_tf32_parts_within_2_to_the_minus_22():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(200_000) * np.float32(2.0) ** rng.integers(-60, 60, 200_000)
         ).astype(np.float32)
    hi, lo = split_tf32(x)
    assert np.array_equal(tf32_rn(hi), hi) and np.array_equal(tf32_rn(lo), lo)
    assert np.array_equal(tf32_trunc(lo), lo)       # the tensor cores read it whole
    resid = np.abs(x.astype(np.float64) - hi.astype(np.float64) - lo.astype(np.float64))
    assert np.all(resid <= 2.0 ** -22 * np.abs(x.astype(np.float64)))


# -- the level tile: byte permute, subtract, 128-byte swizzle -----------------

def _bytes_to_float(b, bias):
    """0x4B0000bb as an f32 (2^23 + bb) minus bias (csrc bytes_to_float4)."""
    f = (np.uint32(0x4B000000) | np.asarray(b, np.uint32)).view(np.float32)
    return (f - np.float32(bias)).astype(np.float32)


def _expand(raw: np.ndarray, kind: str) -> np.ndarray:
    """csrc expand_row for every producer thread r: raw [128, BYTES] block
    bytes -> the level tile as 128 * 32 floats in the swizzled layout (row r
    at r * 32 floats, its 4-float chunk c at chunk c ^ (r % 8)). Q4_0 chunks
    0..3 are the low nibbles of the 16 bytes, 4..7 the high ones; Q8_0 chunk
    c is bytes 4c..4c+3."""
    tile = np.full(128 * 32, np.nan, np.float32)
    for r in range(128):
        if kind == "q4_0":
            vals = np.concatenate([raw[r] & 15, raw[r] >> 4]).astype(np.uint32)
            bias = 8388608.0 + 8.0
        else:
            vals, bias = (raw[r] ^ 0x80).astype(np.uint32), 8388608.0 + 128.0
        for c in range(8):
            p = c ^ (r & 7)
            tile[r * 32 + 4 * p:r * 32 + 4 * p + 4] = _bytes_to_float(vals[4 * c:4 * c + 4], bias)
    return tile


def _wgmma_reads(tile: np.ndarray, kk: int) -> np.ndarray:
    """The B operand [128 n, 8 k] one m64n128k8 reads for k-step kk through
    the descriptor (start + 32 kk bytes, 128-byte rows, 8-row atoms 1024
    bytes apart): byte address a of row r, k j is swizzled by XORing bits
    7..9 into bits 4..6."""
    out = np.empty((128, 8), np.float32)
    for r in range(128):
        for j in range(8):
            a = 32 * kk + r * 128 + 4 * j
            a ^= ((a >> 7) & 7) << 4
            out[r, j] = tile[a // 4]
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_level_tile_holds_the_exact_levels_where_wgmma_reads_them(kind):
    rng = np.random.default_rng(1)
    if kind == "q4_0":
        nib = rng.integers(0, 16, (128, 32)).astype(np.uint8)
        raw = nib[:, :16] | (nib[:, 16:] << 4)        # GGUF: byte j holds j and j + 16
        levels = nib.astype(np.float32) - 8
    else:
        q = rng.integers(-128, 128, (128, 32)).astype(np.int8)
        raw, levels = q.view(np.uint8), q.astype(np.float32)
    tile = _expand(raw, kind)
    assert not np.isnan(tile).any()
    assert np.array_equal(tf32_rn(tile), tile)
    for kk in range(4):
        assert np.array_equal(_wgmma_reads(tile, kk), levels[:, 8 * kk:8 * kk + 8])


# -- the accumulation ----------------------------------------------------------

def _mma(acc, a, b):
    """One k8 MMA step: acc + a @ b with exact products, rounded toward zero
    to f32 (acc None: the fresh accumulator of scale-d 0)."""
    s = a.astype(np.float64) @ b.astype(np.float64)
    return _rz(s if acc is None else acc.astype(np.float64) + s)


def _tile(k: int, kind: str, seed: int = 5):
    """x [16, k] f32, levels [k, 32] and fp16 scales [k / 32, 32] of one
    16 x 32 tile of y (32 weight rows)."""
    rng = np.random.default_rng(seed + k)
    x = rng.standard_normal((16, k)).astype(np.float32)
    if kind == "q4_0":
        lev = rng.integers(-8, 8, (k, 32)).astype(np.float32)
        d = rng.uniform(0.001, 0.02, (k // QK, 32))
    else:
        lev = rng.integers(-127, 128, (k, 32)).astype(np.float32)
        d = rng.uniform(0.001, 0.02, (k // QK, 32)) / 16
    return x, lev, d.astype(np.float16).astype(np.float32)


def _kernel_emulated(x, lev, d, n_split=1):
    """The kernel's y tile: per quant block the 4 lo then 4 hi k8 MMAs into
    a fresh accumulator, joined by fl32(d * blk + acc); the parts of K
    (qmatmul_plan's bounds) added in order."""
    hi, lo = split_tf32(x)
    nblk = x.shape[1] // QK
    bounds = [z * nblk // n_split for z in range(n_split + 1)]
    y = None
    for b0, b1 in zip(bounds[:-1], bounds[1:]):
        acc = np.zeros((x.shape[0], lev.shape[1]), np.float32)
        for kb in range(b0, b1):
            blk = None
            for a in (lo, hi):
                for kk in range(4):
                    k0 = kb * QK + 8 * kk
                    blk = _mma(blk, a[:, k0:k0 + 8], lev[k0:k0 + 8])
            acc = (d[kb].astype(np.float64) * blk + acc).astype(np.float32)
        y = acc if y is None else (y + acc).astype(np.float32)
    return y


def _one_chain(x, lev, d):
    """The negative control: the scale folded into the weight (level * d,
    exact in f32) split in two TF32 parts like x, three MMAs a k8 step (lo x
    hi w, hi x lo w, hi x hi w) in one accumulator chain over all of K."""
    w = lev * np.repeat(d, QK, axis=0)
    xh, xl = split_tf32(x)
    wh, wl = split_tf32(w)
    acc = np.zeros((x.shape[0], lev.shape[1]), np.float32)
    for k0 in range(0, x.shape[1], 8):
        s = slice(k0, k0 + 8)
        for a, b in ((xl, wh), (xh, wl), (xh, wh)):
            acc = _mma(acc, a[:, s], b[s])
    return acc


def _f32_loop(x, lev, d):
    """An f32 FMA loop over k (round to nearest): y += x[:, k] * w[k]."""
    w = lev * np.repeat(d, QK, axis=0)
    acc = np.zeros((x.shape[0], lev.shape[1]), np.float32)
    for k in range(x.shape[1]):
        acc = (acc.astype(np.float64) + x[:, k:k + 1].astype(np.float64) * w[k]).astype(
            np.float32)
    return acc


def _rms(y, exact):
    return float(np.sqrt(np.mean((y.astype(np.float64) - exact) ** 2)))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [2048, 4096, 5632, 11008])
def test_fresh_block_accumulators_keep_the_error_of_an_f32_loop(k, kind):
    """At TinyLlama-1.1B's (2048, w_down's 5632) and Llama-2-7B's (4096,
    w_down's 11008) contraction lengths the kernel's per-block chains stay
    within an f32 FMA loop's rms error against float64, with K whole or
    split in four parts; one chain in place over all of K does not."""
    x, lev, d = _tile(k, kind)
    exact = x.astype(np.float64) @ (lev.astype(np.float64) * np.repeat(d, QK, 0))
    loop = _rms(_f32_loop(x, lev, d), exact)
    for n_split in (1, 4):
        assert _rms(_kernel_emulated(x, lev, d, n_split), exact) <= loop, n_split
    assert _rms(_one_chain(x, lev, d), exact) >= 3 * _rms(_kernel_emulated(x, lev, d), exact)


def test_a_short_contraction_keeps_the_error_of_an_f32_loop():
    """K 96 (the GPU test's M 130 x N 77 case): 3 quant blocks, where each
    block's round toward zero weighs most against the loop's 96 adds."""
    for kind in KINDS:
        x, lev, d = _tile(96, kind)
        exact = x.astype(np.float64) @ (lev.astype(np.float64) * np.repeat(d, QK, 0))
        assert _rms(_kernel_emulated(x, lev, d), exact) <= _rms(_f32_loop(x, lev, d), exact)


# -- the plan ------------------------------------------------------------------

TINY = [(2560, 2048), (2048, 2048), (11264, 2048), (2048, 5632), (32000, 2048)]
LLAMA7B = [(12288, 4096), (4096, 4096), (22016, 4096), (4096, 11008), (32000, 4096)]


@pytest.mark.parametrize("sm_count", [132, 114, 16, 1])
@pytest.mark.parametrize("m,n,k", [(m, n, k) for m in (128, 512) for n, k in TINY + LLAMA7B] +
                         [(5, 96, 64), (7, 2560, 2048), (33, 1000, 576), (77, 1000, 512),
                          (130, 77, 96), (512, 333, 5632), (300, 129, 32)])
def test_plan_covers_every_quant_block_once(m, n, k, sm_count):
    plan = qmatmul_plan(m, n, k, sm_count)
    nblk = k // QK
    assert 1 <= plan.n_split <= FWD_MAX_SPLIT and len(plan.parts) == plan.n_split
    assert plan.n_split == 1 or nblk // plan.n_split >= FWD_MIN_STAGES
    covered = np.zeros(nblk, np.int64)
    for b, e in plan.parts:
        assert b < e
        covered[b:e] += 1
    assert np.all(covered == 1)
    assert plan.parts[0][0] == 0 and plan.parts[-1][1] == nblk
    # the kernel's bounds for grid z
    assert plan.parts == tuple((z * nblk // plan.n_split, (z + 1) * nblk // plan.n_split)
                               for z in range(plan.n_split))


@pytest.mark.parametrize("n,k", TINY + LLAMA7B)
def test_plan_fills_the_h100_at_a_prefill_chunk(n, k):
    """132 SMs, one block each, M 128: the grid (tiles x parts) keeps at
    least two thirds of the SMs busy in its last wave."""
    plan = qmatmul_plan(128, n, k, 132)
    blocks = -(-n // FWD_BN) * -(-128 // FWD_BM) * plan.n_split
    last = blocks - 132 * (-(-blocks // 132) - 1)
    assert last >= 88, (blocks, plan.n_split)
