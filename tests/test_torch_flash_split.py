"""The prefill flash kernel's design (K3, K9 and K10f, csrc/flash_attn.cu),
held on the CPU before the card sees it.

- ``flash_split_plan``: every live key of every row tile falls in exactly
  one split, and no split is empty while its tile has a key tile for it.
- The kernel's two stages in torch (``flash_partials_ref``, then
  ``combine_partials_ref``) equal the one-stage plain versions
  (flash_attention_ref, flash_attention_q8_ref, flash_fwd_lse_ref) within
  1e-6 * max|o| (and max|lse|), splits and rows with no live key included;
  and, from the same numpy inputs, the JAX kernels in interpret mode at
  ZGML_TPU_PREFILL_BF16=0, ZGML_TPU_SCALES=f16 within 1e-5, as
  tests/test_torch_attention.py holds the one-stage version.
- The split-TF32 operands: ``tf32_rn`` (round to nearest, ties away, to 10
  stored mantissa bits, as cvt.rna.tf32.f32) leaves bf16 values and int8
  levels as they are, and K3 / K9 with q and p split into two TF32 parts
  stay within 2e-6 of float64 at the Llama-2-7B chunk at q_offset 1408. This
  bounds the operand rounding only: the card's accumulation order is held
  by the GPU tests and the chip smoke (1e-5).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zgml_tpu.ops import flash_vjp as jfv
from zgml_tpu.ops.attention import flash_attention_pallas, flash_attention_q8_pallas
from zgml_tpu.quant import kv_cache as jkv

from zgml_tpu_torch.ops.attention import (FLASH_BLOCKS_PER_SM, FLASH_BM, combine_partials_ref,
                                          flash_attention_q8_ref, flash_attention_ref, flash_bn,
                                          flash_partials_ref, flash_split_plan)
from zgml_tpu_torch.ops.flash_vjp import flash_fwd_lse_ref

torch.set_num_threads(1)

H100_SMS = 132

# (B, Hkv, n_rep, Tq, q_offset, kv_len, D, SM count[, blocks per SM])
PLAN_CASES = [
    # the smoke's TinyLlama-1.1B chunks (K3 and K9), its K9 chunk 12 of 1536
    (1, 4, 8, 128, 0, 128, 64, H100_SMS),
    (1, 4, 8, 128, 128, 256, 64, H100_SMS),
    (1, 4, 8, 128, 128, 200, 64, H100_SMS),
    (1, 4, 8, 128, 1408, 1536, 64, H100_SMS),
    # the Llama-2-7B chunks: MHA, head_dim 128
    (1, 32, 1, 128, 0, 128, 128, H100_SMS),
    (1, 32, 1, 128, 128, 256, 128, H100_SMS),
    (1, 32, 1, 128, 1408, 1536, 128, H100_SMS),
    # K10f: the training shapes and a live prefix shorter than S at an offset
    (4, 4, 8, 512, 0, 512, 64, H100_SMS),
    (1, 32, 1, 512, 0, 512, 128, H100_SMS),
    (1, 4, 8, 128, 172, 300, 64, H100_SMS),
    # ragged: Tq not a multiple of 16, kv_len inside a tile, n_rep 8 with Tq 40
    (1, 2, 4, 37, 163, 200, 64, H100_SMS),
    (1, 4, 8, 40, 360, 400, 64, H100_SMS),
    (2, 4, 8, 128, 1408, 1000, 64, H100_SMS),
    (1, 8, 1, 128, 896, 1024, 128, H100_SMS),
    (2, 2, 2, 16, 48, 64, 16, H100_SMS),
    (1, 1, 4, 40, 37, 77, 32, H100_SMS),
    # kv_len that ends before the chunk starts; no live key at all
    (1, 4, 8, 128, 300, 100, 64, H100_SMS),
    (1, 2, 4, 8, 0, 0, 32, H100_SMS),
    # other cards: few SMs (no split), many (splits capped by the prefix)
    (1, 4, 8, 128, 1408, 1536, 64, 8),
    (1, 32, 1, 128, 1408, 1536, 128, 1),
    (1, 1, 1, 16, 4000, 4096, 128, 1024),
    (1, 1, 1, 1, 2047, 2048, 64, 264),
    # other occupancies: the TinyLlama long chunk at 3 and 4 blocks per SM
    (1, 4, 8, 128, 1408, 1536, 64, H100_SMS, 3),
    (1, 4, 8, 128, 1408, 1536, 32, H100_SMS, 4),
    (1, 32, 1, 128, 1408, 1536, 128, H100_SMS, 1),
]


@pytest.mark.parametrize("case", PLAN_CASES, ids=str)
def test_split_plan_covers_every_live_key_once(case):
    b, hkv, n_rep, tq, q_off, kv_len, d, sms, *per = case
    per_sm = per[0] if per else FLASH_BLOCKS_PER_SM
    plan = flash_split_plan(b, hkv * n_rep, hkv, tq, d, kv_len, q_off, sms, per_sm)
    tiles = b * hkv * plan.n_m
    assert plan.bm == FLASH_BM and plan.bn == flash_bn(d) and plan.n_split >= 1
    assert plan.n_m == -(-n_rep * tq // FLASH_BM)
    if plan.n_split > 1:          # split only as far as one wave of blocks holds
        assert tiles * plan.n_split <= per_sm * sms
    rows = n_rep * tq
    for m in range(plan.n_m):
        r = np.arange(m * FLASH_BM, min(rows, (m + 1) * FLASH_BM))
        lim = np.clip(np.minimum(kv_len, q_off + r // n_rep + 1), 0, None)   # per row
        end = plan.tile_key_end(m)
        assert end == lim.max()
        seen = np.zeros(end, np.int64)
        ranges = [plan.split_keys(m, s) for s in range(plan.n_split)]
        for k0, k1 in ranges:
            assert k0 <= k1 and k0 % plan.bn == 0
            seen[k0:k1] += 1
        assert (seen == 1).all()              # every key of the tile exactly once
        assert [k0 for k0, _ in ranges] == sorted(k0 for k0, _ in ranges)
        n_kt = -(-end // plan.bn)
        empty = sum(k0 == k1 for k0, k1 in ranges)
        assert empty == max(0, plan.n_split - n_kt)   # none while a key tile remains
        for lim_r in lim:                    # each row's live keys lie in the tile's
            assert lim_r <= end


def test_split_plan_splits_the_long_prefix_on_an_h100():
    """The chunks the split is for: 64 tiles for 132 SMs, 24 / 48 key tiles."""
    for hkv, n_rep, d in ((4, 8, 64), (32, 1, 128)):
        plan = flash_split_plan(1, hkv * n_rep, hkv, 128, d, 1536, 1408, H100_SMS)
        assert 1 < plan.n_split <= 1536 // plan.bn
        assert 64 * plan.n_split <= FLASH_BLOCKS_PER_SM * H100_SMS      # one wave
        assert flash_split_plan(1, hkv * n_rep, hkv, 128, d, 1536, 1408, 1).n_split == 1
    # the training batch fills the card alone: one split, no combine
    assert flash_split_plan(4, 32, 4, 512, 64, 512, 0, H100_SMS).n_split == 1


def _bf16_inputs(seed, b, hq, hkv, tq, rows, s, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, tq, d)).astype(np.float32)
    k = torch.from_numpy(rng.standard_normal((rows, hkv, s, d)).astype(np.float32)).bfloat16()
    v = torch.from_numpy(rng.standard_normal((rows, hkv, s, d)).astype(np.float32)).bfloat16()
    return q, k, v


def _q8_inputs(seed, b, hq, hkv, tq, rows, s, d):
    """q, and the int8 cache (levels, scales) of random K / V for both
    packages: JAX's d-major columns and the port's position-major ones."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, tq, d)).astype(np.float32)
    out = []
    for _ in range(2):
        lev, sc = jkv.quantize_columns(
            jnp.asarray(rng.standard_normal((rows, hkv, s, d)).astype(np.float32)))
        port = (torch.from_numpy(np.array(np.asarray(lev).swapaxes(-1, -2), order="C")),
                torch.from_numpy(np.array(sc)))
        out.append(((lev, sc), port))
    return q, out


def _two_stage(q, k, v, kv_len, q_off, kv_row, sms, ks=None, vs=None):
    b, hq, tq, d = q.shape
    plan = flash_split_plan(b, hq, k.shape[1], tq, d, min(kv_len, k.shape[2]), q_off, sms)
    o, lse = combine_partials_ref(*flash_partials_ref(q, k, v, kv_len, q_off, kv_row, plan,
                                                      ks, vs))
    return plan, o, lse


def _assert_rel(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err, top = np.max(np.abs(got - want)), np.max(np.abs(want))
    assert err <= rtol * top, (what, err, top)


# b, hq, hkv, tq, rows, s, d, kv_len, q_offset, kv_row, SM count
STAGE_CASES = [
    (1, 8, 2, 16, 1, 1024, 64, 1000, 984, 0, H100_SMS),     # n_rep 4, long prefix: 8 splits
    (2, 4, 4, 24, 3, 1024, 32, 700, 640, 1, H100_SMS),       # batch 2 through kv_row
    (1, 8, 2, 37, 1, 512, 16, 200, 163, 0, H100_SMS),        # Tq 37, kv_len inside a tile
    (1, 4, 4, 128, 1, 256, 128, 128, 0, 0, H100_SMS),        # hd 128: rows with no key in split 1
    (1, 32, 4, 40, 1, 512, 64, 400, 360, 0, H100_SMS),       # n_rep 8, Tq 40
    (1, 8, 2, 8, 1, 64, 32, 0, 0, 0, H100_SMS),              # no live key: 0, lse +inf
    (1, 8, 2, 64, 1, 512, 64, 512, 448, 0, 1),               # one SM: no split
]


@pytest.mark.parametrize("b,hq,hkv,tq,rows,s,d,kv_len,q_off,kv_row,sms", STAGE_CASES)
def test_two_stage_plain_equals_one_stage(b, hq, hkv, tq, rows, s, d, kv_len, q_off, kv_row, sms):
    q, k, v = _bf16_inputs(kv_len + d + tq, b, hq, hkv, tq, rows, s, d)
    q = torch.from_numpy(q)
    plan, o, lse = _two_stage(q, k, v, kv_len, q_off, kv_row, sms)
    want = flash_attention_ref(q, k, v, kv_len, q_off, kv_row)
    assert o.shape == want.shape == (b, hq, tq, d)
    _assert_rel(o, want, 1e-6, f"K3, {plan.n_split} splits")
    if kv_len == 0:
        assert torch.count_nonzero(o) == 0 and bool(torch.isinf(lse).all())
    # K10f reads batch row b of k / v (no kv_row): its o and lse
    kb, vb = k[kv_row:kv_row + b], v[kv_row:kv_row + b]
    o10, lse10 = flash_fwd_lse_ref(q, kb, vb, kv_len, q_off)
    _, o2, lse2 = _two_stage(q, kb, vb, kv_len, q_off, 0, sms)
    _assert_rel(o2, o10, 1e-6, "K10f o")
    fin = torch.isfinite(lse10)
    assert torch.equal(fin, torch.isfinite(lse2))
    if bool(fin.any()):
        _assert_rel(lse2[fin], lse10[fin], 1e-6, "K10f lse")
    # K9 on an int8 cache of the same shape
    _, ((_, pk), (_, pv)) = _q8_inputs(kv_len + d, b, hq, hkv, tq, rows, s, d)
    _, o8, _ = _two_stage(q, pk[0], pv[0], kv_len, q_off, kv_row, sms, pk[1], pv[1])
    _assert_rel(o8, flash_attention_q8_ref(q, pk[0], pk[1], pv[0], pv[1], kv_len, q_off, kv_row),
                1e-6, "K9")


@pytest.fixture
def f32_prefill(monkeypatch):
    monkeypatch.setenv("ZGML_TPU_PREFILL_BF16", "0")
    monkeypatch.setenv("ZGML_TPU_SCALES", "f16")


# b, hq, hkv, tq, rows, s, d, kv_len, q_offset, kv_row: small enough for
# interpret mode, each split by the plan of an H100
JAX_CASES = [
    (1, 8, 2, 16, 1, 256, 64, 200, 184, None),     # n_rep 4, 4 key tiles over splits
    (2, 4, 4, 16, 2, 256, 32, 256, 240, None),     # batch 2, MHA
    (1, 4, 4, 16, 3, 384, 128, 300, 284, 2),       # head_dim 128, kv_row
]


@pytest.mark.parametrize("b,hq,hkv,tq,rows,s,d,kv_len,q_off,kv_row", JAX_CASES)
def test_two_stage_matches_jax_kernels(f32_prefill, b, hq, hkv, tq, rows, s, d, kv_len, q_off,
                                       kv_row):
    """K3 and K10f on a bf16 cache, K9 on an int8 one, split as on an H100,
    against the JAX Pallas kernels in interpret mode on the same inputs."""
    q, k, v = _bf16_inputs(s + tq + d, b, hq, hkv, tq, rows, s, d)
    tq_ = torch.from_numpy(q)
    jk = jnp.asarray(k.float().numpy(), jnp.bfloat16)
    jv = jnp.asarray(v.float().numpy(), jnp.bfloat16)
    plan, o, _ = _two_stage(tq_, k, v, kv_len, q_off, kv_row or 0, H100_SMS)
    assert plan.n_split > 1
    want = flash_attention_pallas(jnp.asarray(q), jk, jv, kv_len=kv_len, q_offset=q_off,
                                  kv_row=kv_row)
    _assert_rel(o.numpy(), np.asarray(want), 1e-5, "K3 vs JAX")

    row = kv_row or 0
    kb, vb = k[row:row + b], v[row:row + b]
    _, o10, lse10 = _two_stage(tq_, kb, vb, kv_len, q_off, 0, H100_SMS)
    kw = dict(hq=hq, n_rep=hq // hkv, bq=min(128, tq), bk=min(128, s), scale=1.0 / d ** 0.5,
              bf16=False)
    jkb = jk[row:row + b].reshape(b * hkv, s, d)
    jvb = jv[row:row + b].reshape(b * hkv, s, d)
    jo, jlse = jfv._flash_fwd(jnp.asarray(q.reshape(b * hq, tq, d)), jkb, jvb,
                              jnp.asarray([kv_len, q_off, 0], jnp.int32), **kw)
    _assert_rel(o10.numpy(), np.asarray(jo).reshape(b, hq, tq, d), 1e-5, "K10f o vs JAX")
    _assert_rel(lse10.numpy(), np.asarray(jlse)[..., 0].reshape(b, hq, tq), 1e-5,
                "K10f lse vs JAX")

    q8, (((kq, kss), pk), ((vq, vss), pv)) = _q8_inputs(s + kv_len, b, hq, hkv, tq, rows, s, d)
    _, o8, _ = _two_stage(torch.from_numpy(q8), pk[0], pv[0], kv_len, q_off, row, H100_SMS,
                          pk[1], pv[1])
    want8 = flash_attention_q8_pallas(jnp.asarray(q8), kq, kss, vq, vss, kv_len=kv_len,
                                      q_offset=q_off, kv_row=kv_row)
    _assert_rel(o8.numpy(), np.asarray(want8), 1e-5, "K9 vs JAX")


def tf32_rn(x) -> np.ndarray:
    """f32 values rounded to TF32 (10 stored mantissa bits, to nearest, ties
    away from zero), as cvt.rna.tf32.f32 and the kernel's mask make them."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split_tf32(x):
    hi = tf32_rn(x)
    return hi, tf32_rn(np.asarray(x, np.float32) - hi)


def test_tf32_rounding_and_its_fixed_points():
    # bf16 values (every exponent's extremes and random ones) and int8 levels
    rng = np.random.default_rng(0)
    bf = torch.from_numpy(rng.standard_normal(100_000).astype(np.float32) *
                          np.float32(2.0) ** rng.integers(-60, 60, 100_000).astype(np.float32))
    bf = bf.bfloat16().float().numpy()
    extremes = torch.tensor([3.3895e38, -3.3895e38, 1.1755e-38, 2 ** -133, 0.0],
                            dtype=torch.bfloat16).float().numpy()
    levels = np.arange(-128, 128, dtype=np.float32)
    for x in (bf, extremes, levels):
        assert np.array_equal(tf32_rn(x), x)
    # to nearest, ties away from zero, at 1 and -1
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    assert tf32_rn(np.float32(one + ulp / 2)) == one + ulp
    assert tf32_rn(np.float32(-(one + ulp / 2))) == -(one + ulp)
    assert tf32_rn(np.float32(one + ulp / 2 - 2.0 ** -23)) == one
    # hi + lo leaves at most 2^-22 |x|
    x = rng.standard_normal(100_000).astype(np.float32)
    hi, lo = split_tf32(x)
    assert np.array_equal(tf32_rn(hi), hi) and np.array_equal(tf32_rn(lo), lo)
    resid = np.abs(x.astype(np.float64) - hi.astype(np.float64) - lo.astype(np.float64))
    assert np.all(resid <= 2.0 ** -22 * np.abs(x.astype(np.float64)))


def _split_dot(eq, a, b, split_b):
    """The kernel's dot of f32 operands a and b in float64: a as its two
    TF32 parts, b exact (bf16 values, int8 levels), or with split_b its
    parts too, the lo . lo product dropped (the f32-K/V form's three
    products)."""
    ah, al = (x.astype(np.float64) for x in split_tf32(a))
    if not split_b:
        return np.einsum(eq, ah + al, b.astype(np.float64))
    bh, bl = (x.astype(np.float64) for x in split_tf32(b))
    return np.einsum(eq, ah, bh) + np.einsum(eq, al, bh) + np.einsum(eq, ah, bl)


def _attend64(q, k, v, lim, scale, ks=None, vs=None, split=False, split_kv=False):
    """Causal attention per query head in float64 with the kernel's operand
    rounding when `split`: q and f32 p each as two TF32 parts (K, V and
    the levels are exact; with split_kv, f32 K and V split as well, the
    f32-K/V form); else the exact float64 function. q [H, T, d]; k, v [H,
    S, d] f32 values; lim [T] live keys per row."""
    if split:
        s = _split_dot("htd,hsd->hts", q, k, split_kv)
    else:
        s = np.einsum("htd,hsd->hts", q.astype(np.float64), k.astype(np.float64))
    s = s * (scale if ks is None else (ks.astype(np.float32) * np.float32(scale))
             .astype(np.float64)[:, None, :])
    s = np.where(np.arange(k.shape[1])[None, None, :] < lim[None, :, None], s, -np.inf)
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    l = p.sum(axis=-1, keepdims=True)
    pv = p if vs is None else p * vs.astype(np.float64)[:, None, :]
    if split:
        return _split_dot("hts,hsd->htd", pv.astype(np.float32), v, split_kv) / l
    return np.einsum("hts,hsd->htd", pv, v.astype(np.float64)) / l


def test_split_tf32_operands_stay_within_2e6_of_float64():
    """K3 and K9 at the Llama-2-7B chunk at q_offset 1408 (32 heads, head_dim
    128, kv_len 1536): the kernel's operand rounding against float64."""
    h, tq, d, kv_len, q_off = 32, 128, 128, 1536, 1408
    rng = np.random.default_rng(7)
    q = rng.standard_normal((h, tq, d)).astype(np.float32)
    lim = np.minimum(kv_len, q_off + np.arange(tq) + 1)
    scale = 1.0 / d ** 0.5
    k = torch.from_numpy(rng.standard_normal((h, kv_len, d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((h, kv_len, d)).astype(np.float32))
    kb, vb = k.bfloat16().float().numpy(), v.bfloat16().float().numpy()
    err3 = np.max(np.abs(_attend64(q, kb, vb, lim, scale, split=True) -
                         _attend64(q, kb, vb, lim, scale)))
    assert err3 <= 2e-6, err3
    from zgml_tpu_torch.quant.kv_cache import quantize_columns
    (kq, ks), (vq, vs) = quantize_columns(k), quantize_columns(v)
    kq, vq = kq.float().numpy(), vq.float().numpy()
    ks, vs = ks.numpy(), vs.numpy()
    err9 = np.max(np.abs(_attend64(q, kq, vq, lim, scale, ks, vs, split=True) -
                         _attend64(q, kq, vq, lim, scale, ks, vs)))
    assert err9 <= 2e-6, err9


@pytest.mark.parametrize("d,q_off", [(64, 0), (64, 768), (128, 768)])
def test_split_tf32_f32_kv_operands_stay_within_2e6_of_float64(d, q_off):
    """The f32-K/V form (a ring hop under ZGML_TPU_PREFILL_BF16=0, K/V not
    bf16 values) at TinyLlama's cp2 hop (768 rows over 768 keys; the
    diagonal hop and a past block) and at head_dim 128: q, p, K and V each
    split into TF32 parts, three products a dot, against float64."""
    h, t = 4, 768
    rng = np.random.default_rng(d + q_off)
    q, k, v = (rng.standard_normal((h, t, d)).astype(np.float32) for _ in range(3))
    lim = np.minimum(t, q_off + np.arange(t) + 1)
    scale = 1.0 / d ** 0.5
    err = np.max(np.abs(_attend64(q, k, v, lim, scale, split=True, split_kv=True)
                        - _attend64(q, k, v, lim, scale)))
    assert err <= 2e-6, err
    # K/V's hi parts alone (two products a dot, as over bf16 K/V) keep
    # TF32's 11 bits of them: the third product is what keeps f32's error
    kh, vh = split_tf32(k)[0], split_tf32(v)[0]
    err2 = np.max(np.abs(_attend64(q, kh, vh, lim, scale, split=True)
                         - _attend64(q, k, v, lim, scale)))
    assert err2 > 10 * err, (err2, err)


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


def _flash_emulated(q, k, v, scale, bn, pv):
    """The kernel's forward for one causal head [T, D] over K / V [T, D] with
    tensor-core accumulation. pv "fresh": S in three chains (hi products of
    even and odd k-steps, lo products) and each tile's P V in fresh hi / lo
    accumulators joined by an f32 fma, as csrc/flash_attn.cu; "inplace": the
    same S, P V into O in place (what fits in registers at D = 128 with O
    held there); "single": one chain for S and O in place (the first
    design)."""
    t, d = q.shape
    qh, ql = split_tf32(q)
    live = np.arange(t)[None, :] <= np.arange(t)[:, None]
    m = np.full(t, -np.inf, np.float32)
    l = np.zeros(t, np.float32)
    acc = np.zeros((t, d), np.float32)
    for t0 in range(0, t, bn):
        kt, vt = k[t0:t0 + bn].T, v[t0:t0 + bn]
        c = [np.zeros((t, kt.shape[1]), np.float32) for _ in range(3)]
        for i, k0 in enumerate(range(0, d, 8)):
            hi, lo = (0, 0) if pv == "single" else (i & 1, 2)
            c[hi] = _mma(c[hi], qh[:, k0:k0 + 8], kt[k0:k0 + 8])
            c[lo] = _mma(c[lo], ql[:, k0:k0 + 8], kt[k0:k0 + 8])
        s = ((c[0] + c[1]) + c[2]) * scale
        s = np.where(live[:, t0:t0 + bn], s, np.float32(-np.inf))
        m_new = np.maximum(m, s.max(1))
        m_use = np.where(m_new == -np.inf, 0, m_new).astype(np.float32)
        alpha = np.exp(m - m_use).astype(np.float32)
        p = np.exp(s - m_use[:, None]).astype(np.float32)
        l = (l * alpha + p.sum(1, dtype=np.float32)).astype(np.float32)
        m = m_new
        ph, pl = split_tf32(p)
        if pv == "fresh":
            oh = np.zeros_like(acc)
            ol = np.zeros_like(acc)
            for k0 in range(0, vt.shape[0], 8):
                oh = _mma(oh, ph[:, k0:k0 + 8], vt[k0:k0 + 8])
                ol = _mma(ol, pl[:, k0:k0 + 8], vt[k0:k0 + 8])
            acc = (acc.astype(np.float64) * alpha[:, None] + (oh + ol)).astype(np.float32)
        else:
            acc = acc * alpha[:, None]
            for k0 in range(0, vt.shape[0], 8):
                acc = _mma(acc, ph[:, k0:k0 + 8], vt[k0:k0 + 8])
                acc = _mma(acc, pl[:, k0:k0 + 8], vt[k0:k0 + 8])
    return acc / l[:, None]


def _flash_f32_loop(q, k, v, scale, bn=32):
    """An f32 FMA flash forward (round to nearest): each score a d-ordered
    fma chain, P V one fma per key, online softmax per bn keys."""
    t, d = q.shape
    s = np.zeros((t, t), np.float32)
    for i in range(d):
        s = (s.astype(np.float64) + q[:, i:i + 1].astype(np.float64) * k[None, :, i]).astype(
            np.float32)
    s = np.where(np.arange(t)[None, :] <= np.arange(t)[:, None], s * scale, np.float32(-np.inf))
    m = np.full(t, -np.inf, np.float32)
    l = np.zeros(t, np.float32)
    acc = np.zeros((t, d), np.float32)
    for t0 in range(0, t, bn):
        st = s[:, t0:t0 + bn]
        m_new = np.maximum(m, st.max(1))
        m_use = np.where(m_new == -np.inf, 0, m_new).astype(np.float32)
        alpha = np.exp(m - m_use).astype(np.float32)
        acc = acc * alpha[:, None]
        p = np.exp(st - m_use[:, None]).astype(np.float32)
        ps = np.zeros(t, np.float32)
        for j in range(st.shape[1]):
            ps = ps + p[:, j]
            acc = (acc.astype(np.float64) + p[:, j:j + 1].astype(np.float64) * v[t0 + j]).astype(
                np.float32)
        l = (l * alpha + ps).astype(np.float32)
        m = m_new
    return acc / l[:, None]


def _rms_errors(t, d, bn, forms):
    """rms error / max|o| against float64 of the emulated forms and of the
    f32 FMA loop, on one causal head of seeded inputs (bf16 K / V)."""
    rng = np.random.default_rng(1)
    scale = np.float32(1 / np.sqrt(d))
    q = rng.standard_normal((t, d)).astype(np.float32)
    k, v = (torch.from_numpy(rng.standard_normal((t, d)).astype(np.float32)).bfloat16()
            .float().numpy() for _ in range(2))
    s = (q.astype(np.float64) @ k.T.astype(np.float64)) * float(scale)
    s = np.where(np.arange(t)[None, :] <= np.arange(t)[:, None], s, -np.inf)
    p = np.exp(s - s.max(1, keepdims=True))
    exact = (p @ v.astype(np.float64)) / p.sum(1, keepdims=True)
    top = np.abs(exact).max()

    def rms(o):
        return float(np.sqrt(np.mean((o - exact) ** 2)) / top)
    out = {f: rms(_flash_emulated(q, k, v, scale, bn, f)) for f in forms}
    out["loop"] = rms(_flash_f32_loop(q, k, v, scale))
    return out


def test_accumulation_chains_keep_the_error_of_an_f32_loop():
    """The tensor cores round each MMA's sum toward zero. At the TinyLlama
    training shape (T 512, head_dim 64, 64-key tiles) the kernel's short
    chains stay within an f32 FMA flash loop's error against float64; one
    chain for S and O in place over the prefix do not (4x the rms error,
    drifting toward zero)."""
    e = _rms_errors(512, 64, 64, ("fresh", "single"))
    assert e["fresh"] <= e["loop"], e
    assert e["single"] >= 3 * e["fresh"], e


@pytest.mark.parametrize("t", [512, 1536])
def test_accumulation_at_head_dim_128(t):
    """At head_dim 128 (32-key tiles, up to the 7B chunk's 1536 keys) the
    kernel's fresh accumulators stay within the f32 loop's error; P V into O
    in place (what O in registers would force there: fresh accumulators
    beside it spill) costs 3x (T 512) to 6.5x (T 1536), under 8x."""
    e = _rms_errors(t, 128, 32, ("fresh", "inplace"))
    assert e["fresh"] <= e["loop"], e
    assert e["loop"] < e["inplace"] <= 8 * e["loop"], e
