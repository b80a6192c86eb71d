"""The flash backward's design (K10dq and K10dkv, csrc/flash_bwd.cu), held on
the CPU before the card sees it.

- The split plans: every live (query, key) pair falls in exactly one part of
  K10dq's plan (K3's, ``attention.flash_split_plan``: a row tile's key tiles
  split over blocks) and of K10dkv's (``flash_vjp.flash_dkv_split_plan``: a
  key tile's query tiles split over blocks), and a split never adds a second
  wave of blocks.
- The kernels' arithmetic, emulated in numpy (``_emulate``): the delta
  pre-pass; q, dO, P and dS split into two TF32 parts (``tf32_rn``, as
  cvt.rna.tf32.f32); two MMA terms per product of an f32 and an exact
  operand (S, dP, dQ), three per product of two f32 operands (dV, dK: hi hi
  + hi lo + lo hi), one exact bf16 product for dK's dP'; S and dP in three
  chains (hi products of even and odd k-steps, lo products) added in f32;
  each tile's dQ, dK or dV in fresh accumulators (hi products, small terms)
  joined to the running sum by an f32 add; the splits' partials added in
  split order. A chain's sum is its exact sum rounded once to f32: the
  tensor cores' round toward zero inside a chain, which K10dkv avoids for
  dP' and the hi products by taking each MMA alone (csrc/flash_bwd.cu), is
  held on the card by the GPU tests' rms check against float64 and the
  smoke's training gradients.
- Held: dQ, dK and dV (before their bf16 rounding) within 2e-6 * max of
  float64; dQ within 1e-5 * max of the JAX kernels `_flash_dq` in interpret
  mode at ZGML_TPU_PREFILL_BF16=0 on the same numpy inputs, and the bf16
  dK / dV within one bf16 ulp per element of `_flash_dkv` and of the plain
  version flash_dkv_ref (a sum that rounds the other way; 1e-6 * max for an
  element that cancels below f32 noise, as tests/test_torch_flash_vjp.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zgml_tpu.ops import flash_vjp as jfv

from test_torch_flash_split import _rz, split_tf32, tf32_rn
from test_torch_flash_vjp import _assert_ulps

from zgml_tpu_torch.ops.attention import FLASH_BM, FlashPlan, flash_split_plan
from zgml_tpu_torch.ops.flash_vjp import (DKV_BK, DKV_BQ, DQ_BN, flash_dkv_ref,
                                          flash_dkv_split_plan, flash_dq_ref, flash_fwd_lse_ref)

torch.set_num_threads(1)

H100_SMS = 132

# (B, Hq, Hkv, Tq, S, kv_len, q_offset, SM count, blocks per SM) for the plans
PLAN_CASES = [
    (4, 32, 4, 512, 512, 512, 0, H100_SMS, 2),        # TinyLlama training: no split
    (1, 32, 32, 512, 512, 512, 0, H100_SMS, 1),       # Llama-2-7B heads
    (1, 32, 4, 128, 512, 300, 172, H100_SMS, 2),      # the smoke's kv_len < S case
    (1, 8, 2, 256, 256, 256, 0, H100_SMS, 2),         # a short grid: both split
    (1, 4, 4, 256, 512, 400, 100, H100_SMS, 1),
    (2, 4, 1, 40, 96, 77, 37, H100_SMS, 2),           # ragged tiles
    (1, 8, 2, 64, 64, 0, 0, H100_SMS, 2),             # no live key
    (1, 2, 2, 1000, 1024, 1024, 24, 8, 1),            # few SMs
]


def _live(tq, s, kv_len, q_off):
    """[Tq, S] bool: query i attends key j."""
    i = np.arange(tq)[:, None] + q_off
    j = np.arange(s)[None, :]
    return (j < kv_len) & (j <= i)


@pytest.mark.parametrize("case", PLAN_CASES, ids=str)
def test_dkv_plan_covers_every_pair_once(case):
    b, hq, hkv, tq, s, kv_len, q_off, sms, per_sm = case
    plan = flash_dkv_split_plan(b, hq, tq, s, kv_len, q_off, sms, per_sm)
    assert plan.bk == DKV_BK and plan.bq == DKV_BQ and plan.n_split >= 1
    live_tiles = b * hq * -(-min(kv_len, s) // DKV_BK)
    if plan.n_split > 1:          # split only as far as one wave of blocks holds
        assert live_tiles * plan.n_split <= per_sm * sms
    live = _live(tq, s, kv_len, q_off)
    seen = np.zeros((tq, s), np.int64)
    for jt in range(plan.n_kt):
        keys = slice(jt * DKV_BK, min(s, (jt + 1) * DKV_BK))
        parts = [plan.split_queries(jt, z) for z in range(plan.n_split)]
        assert [i0 for i0, _ in parts] == sorted(i0 for i0, _ in parts)
        for i0, i1 in parts:
            assert i0 <= i1 and i0 % DKV_BQ == 0
            seen[i0:i1, keys] += 1
    assert (seen[live] == 1).all()
    assert (seen <= 1).all()


@pytest.mark.parametrize("case", PLAN_CASES, ids=str)
def test_dq_plan_covers_every_pair_once(case):
    """K10dq takes K3's row tiles and split rule (at its own key tile and
    occupancy): each live pair of every packed row falls in one split's
    keys."""
    b, hq, hkv, tq, s, kv_len, q_off, sms, per_sm = case
    plan = flash_split_plan(b, hq, hkv, tq, 128, min(kv_len, s), q_off, sms, per_sm, bn=DQ_BN)
    assert plan.bn == DQ_BN
    n_rep = hq // hkv
    live = _live(tq, s, kv_len, q_off)
    for m in range(plan.n_m):
        rows = np.arange(m * FLASH_BM, min(n_rep * tq, (m + 1) * FLASH_BM))
        seen = np.zeros((len(rows), s), np.int64)
        for z in range(plan.n_split):
            k0, k1 = plan.split_keys(m, z)
            seen[:, k0:k1] += 1
        assert (seen[live[rows // n_rep]] == 1).all()


# -- the kernels' arithmetic ---------------------------------------------------

def _f32(x):
    return np.asarray(x, np.float64).astype(np.float32)


def _dot(a, b):
    """[..., R, K] x [..., K, C] summed exactly (float64) and rounded once."""
    return _f32(np.einsum("...rk,...kc->...rc", a.astype(np.float64), b.astype(np.float64)))


def _chains(a_hi, a_lo, b):
    """A tile's S or dP in the kernels' three chains over the contraction
    (8 at a time): hi products of even and of odd k-steps, lo products;
    ((even + odd) + lo) in f32."""
    kd = a_hi.shape[-1]
    even = np.concatenate([np.arange(k, min(k + 8, kd)) for k in range(0, kd, 16)])
    odd = np.setdiff1d(np.arange(kd), even)
    s0 = _dot(a_hi[..., even], b[..., even, :])
    s1 = _dot(a_hi[..., odd], b[..., odd, :]) if len(odd) else np.zeros_like(s0)
    return _f32(_f32(s0 + s1) + _dot(a_lo, b))


def _emulate(q, k, v, do, o, lse, kv_len, q_off, n_split_q=1, n_split_kv=1):
    """dQ, dK, dV (f32, per query head, before dK / dV round to bf16) as the
    kernels compute them. q, do, o f32 [B, Hq, Tq, D]; k, v bf16-valued f32
    [B, Hkv, S, D]; lse f32 [B, Hq, Tq]. n_split_q: dQ's key tiles split in
    that many parts (K3's rule); n_split_kv: dK / dV's query tiles."""
    b, hq, tq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    scale = np.float32(1.0 / d ** 0.5)
    kx = np.repeat(k, hq // hkv, axis=1)            # query head h reads KV head h // n_rep
    vx = np.repeat(v, hq // hkv, axis=1)
    delta = _f32((do.astype(np.float64) * o).sum(-1))              # the pre-pass
    qh, ql = split_tf32(q)
    dh, dl = split_tf32(do)
    dob = torch.from_numpy(do).bfloat16().float().numpy()
    live = _live(tq, s, kv_len, q_off)
    kvn = min(kv_len, s)

    def probs(i, j):
        """p, dS (dQ's) and dS' (dK's) of queries i x keys j, all heads."""
        sc = _chains(qh[:, :, i], ql[:, :, i], np.swapaxes(kx[:, :, j], -1, -2))
        x = _f32(sc * scale)
        p = np.where(live[np.ix_(i, j)], _f32(np.exp(_f32(x - lse[:, :, i, None]))),
                     np.float32(0))
        dp = _chains(dh[:, :, i], dl[:, :, i], np.swapaxes(vx[:, :, j], -1, -2))
        dpb = _dot(dob[:, :, i], np.swapaxes(vx[:, :, j], -1, -2))
        ds = _f32(_f32(p * _f32(dp - delta[:, :, i, None])) * scale)
        dsb = _f32(_f32(p * _f32(dpb - delta[:, :, i, None])) * scale)
        return p, ds, dsb

    def split3(a_hi, a_lo, b_hi, b_lo):
        """A tile's a^T b in the three-term form: fresh hi hi and small-term
        accumulators, added in f32."""
        return _f32(_dot(a_hi, b_hi) + _f32(_dot(a_hi, b_lo) + _dot(a_lo, b_hi)))

    # dQ: the n_rep heads of a position share K3's packed row tile m, whose
    # key tiles each split takes (FlashPlan.split_keys), summed apart
    bn, n_rep = DQ_BN, hq // hkv
    plan_q = FlashPlan(FLASH_BM, bn, n_rep, tq, kvn, q_off, n_split_q)
    dq = np.zeros((b, hq, tq, d), np.float32)
    for i in range(tq):
        m = i * n_rep // FLASH_BM
        parts = []
        for z in range(n_split_q):
            acc = np.zeros((b, hq, 1, d), np.float32)
            k0, k1 = plan_q.split_keys(m, z)
            for j0 in range(k0, k1, bn):
                j = np.arange(j0, min(s, j0 + bn))
                _, ds, _ = probs(np.array([i]), j)
                sh, sl = split_tf32(ds)
                acc = _f32(acc + _f32(_dot(sh, kx[:, :, j]) + _dot(sl, kx[:, :, j])))
            parts.append(acc)
        tot = parts[0]
        for x in parts[1:]:
            tot = _f32(tot + x)
        dq[:, :, i:i + 1] = tot

    # dK, dV: key tiles of DKV_BK, query tiles of DKV_BQ from the first that
    # reaches the tile
    dk = np.zeros((b, hq, s, d), np.float32)
    dv = np.zeros((b, hq, s, d), np.float32)
    plan = flash_dkv_split_plan(b, hq, tq, s, kv_len, q_off, 1, 1)
    for jt in range(plan.n_kt):
        j = np.arange(jt * DKV_BK, min(s, (jt + 1) * DKV_BK))
        first, n = plan.query_tiles(jt)
        pk, pv = [], []
        for z in range(n_split_kv):
            ak = np.zeros((b, hq, len(j), d), np.float32)
            av = np.zeros_like(ak)
            for qt in range(first + z * n // n_split_kv, first + (z + 1) * n // n_split_kv):
                i = np.arange(qt * DKV_BQ, min(tq, (qt + 1) * DKV_BQ))
                p, _, dsb = probs(i, j)
                ph, pl = split_tf32(np.swapaxes(p, -1, -2))
                sh, sl = split_tf32(np.swapaxes(dsb, -1, -2))
                av = _f32(av + split3(ph, pl, dh[:, :, i], dl[:, :, i]))
                ak = _f32(ak + split3(sh, sl, qh[:, :, i], ql[:, :, i]))
            pk.append(ak)
            pv.append(av)
        for out, parts in ((dk, pk), (dv, pv)):
            tot = parts[0]
            for x in parts[1:]:
                tot = _f32(tot + x)
            out[:, :, j] = tot
    return dq, dk, dv


def _exact(q, k, v, do, o, lse, kv_len, q_off):
    """dQ, dK, dV (per query head) in float64 from the same inputs."""
    b, hq, tq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    f = np.float64
    kx = np.repeat(k, hq // hkv, axis=1).astype(f)
    vx = np.repeat(v, hq // hkv, axis=1).astype(f)
    sc = np.einsum("bhqd,bhkd->bhqk", q.astype(f), kx) / np.sqrt(d)
    p = np.where(_live(tq, s, kv_len, q_off), np.exp(sc - lse.astype(f)[..., None]), 0.0)
    delta = (do.astype(f) * o.astype(f)).sum(-1)[..., None]
    dob = torch.from_numpy(do).bfloat16().double().numpy()
    ds = p * (np.einsum("bhqd,bhkd->bhqk", do.astype(f), vx) - delta) / np.sqrt(d)
    dsb = p * (np.einsum("bhqd,bhkd->bhqk", dob, vx) - delta) / np.sqrt(d)
    return (np.einsum("bhqk,bhkd->bhqd", ds, kx), np.einsum("bhqk,bhqd->bhkd", dsb, q.astype(f)),
            np.einsum("bhqk,bhqd->bhkd", p, do.astype(f)))


def _assert_rel(got, want, rtol, what):
    err, top = np.max(np.abs(got.astype(np.float64) - want)), np.max(np.abs(want))
    assert err <= rtol * top, (what, err, top)


def _inputs(b, hq, hkv, tq, s, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, tq, d)).astype(np.float32)
    k = torch.from_numpy(rng.standard_normal((b, hkv, s, d)).astype(np.float32)).bfloat16()
    v = torch.from_numpy(rng.standard_normal((b, hkv, s, d)).astype(np.float32)).bfloat16()
    do = rng.standard_normal((b, hq, tq, d)).astype(np.float32)
    return q, k, v, do


@pytest.fixture
def f32_prefill(monkeypatch):
    monkeypatch.setenv("ZGML_TPU_PREFILL_BF16", "0")
    monkeypatch.setenv("ZGML_TPU_SCALES", "f16")


# (B, Hq, Hkv, Tq, S, D, kv_len, q_offset, dQ splits, dK / dV splits): head
# dims 16 / 64 / 128, n_rep 1 and 4, kv_len < S at an offset, splits of
# both plans, and no live key at all
EMU_CASES = [
    (1, 4, 4, 128, 128, 16, 128, 0, 1, 1),
    (1, 8, 2, 128, 256, 64, 200, 72, 2, 1),
    (1, 4, 1, 64, 128, 64, 128, 64, 1, 2),
    (1, 2, 2, 64, 128, 128, 100, 36, 3, 2),
    (1, 8, 2, 64, 128, 64, 0, 0, 1, 1),
]


@pytest.mark.parametrize("case", EMU_CASES, ids=str)
def test_emulated_kernels_match_float64_and_jax(f32_prefill, case):
    b, hq, hkv, tq, s, d, kv_len, q_off, nsq, nskv = case
    q, k, v, do = _inputs(b, hq, hkv, tq, s, d, seed=sum(case))
    kw = dict(hq=hq, n_rep=hq // hkv, bq=min(128, tq), bk=min(128, s), scale=1.0 / d ** 0.5,
              bf16=False)
    lens = jnp.asarray([kv_len, q_off, 0], jnp.int32)
    jq = jnp.asarray(q.reshape(b * hq, tq, d))
    jk = jnp.asarray(k.float().numpy(), jnp.bfloat16).reshape(b * hkv, s, d)
    jv = jnp.asarray(v.float().numpy(), jnp.bfloat16).reshape(b * hkv, s, d)
    jo, jlse = jfv._flash_fwd(jq, jk, jv, lens, **kw)
    jdo = jnp.asarray(do.reshape(b * hq, tq, d))
    jdq = np.asarray(jfv._flash_dq(jq, jk, jv, jdo, jo, jlse, lens, **kw)).reshape(b, hq, tq, d)
    jdk, jdv = (np.asarray(x.astype(jnp.float32)).reshape(b, hq, s, d)
                for x in jfv._flash_dkv(jq, jk, jv, jdo, jo, jlse, lens, **kw))
    o = np.asarray(jo).reshape(b, hq, tq, d)
    lse = np.asarray(jlse)[..., 0].reshape(b, hq, tq)
    kf, vf = k.float().numpy(), v.float().numpy()
    dq, dk, dv = _emulate(q, kf, vf, do, o, lse, kv_len, q_off, nsq, nskv)
    dq64, dk64, dv64 = _exact(q, kf, vf, do, o, lse, kv_len, q_off)
    if kv_len == 0:              # no live key: all three are 0
        assert not dq.any() and not dk.any() and not dv.any()
        assert not jdq.any() and not jdk.any() and not jdv.any()
        return
    for got, want, what in ((dq, dq64, "dq"), (dk, dk64, "dk"), (dv, dv64, "dv")):
        _assert_rel(got, want, 2e-6, what + " vs float64")
    _assert_rel(dq, jdq, 1e-5, "dq vs JAX")
    dkb = torch.from_numpy(dk).bfloat16().float().numpy()
    dvb = torch.from_numpy(dv).bfloat16().float().numpy()
    _assert_ulps(dkb, jdk, "dk vs JAX")
    _assert_ulps(dvb, jdv, "dv vs JAX")
    args = (torch.from_numpy(q), k, v, torch.from_numpy(do), torch.from_numpy(o.copy()),
            torch.from_numpy(lse.copy()), kv_len, q_off)
    pdk, pdv = flash_dkv_ref(*args)
    _assert_ulps(dkb, pdk.float().numpy(), "dk vs plain")
    _assert_ulps(dvb, pdv.float().numpy(), "dv vs plain")
    _assert_rel(dq, flash_dq_ref(*args).numpy(), 1e-5, "dq vs plain")


def test_no_live_row_gives_zero():
    """A row with no live key (kv_len 0: lse +inf from the forward) gives
    p = 0 in every tile, and dQ, dK, dV exactly 0, in the emulation and
    the plain versions."""
    b, hq, hkv, tq, s, d = 1, 4, 2, 32, 64, 32
    q, k, v, do = _inputs(b, hq, hkv, tq, s, d, seed=3)
    tq_, tdo = torch.from_numpy(q), torch.from_numpy(do)
    o, lse = flash_fwd_lse_ref(tq_, k, v, 0, 0)
    assert bool(torch.isinf(lse).all()) and not bool(o.any())
    dq, dk, dv = _emulate(q, k.float().numpy(), v.float().numpy(), do, o.numpy(), lse.numpy(),
                          0, 0)
    assert not dq.any() and not dk.any() and not dv.any()
    assert not bool(flash_dq_ref(tq_, k, v, tdo, o, lse, 0, 0).any())


def test_tf32_split_of_the_operands():
    """The kernels' split of an f32 operand (q, dO, P, dS): hi and lo are
    TF32 values and leave at most 2^-22 |x|; bf16 values (K, V, bf16(dO))
    are TF32 values already."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal(50_000).astype(np.float32) * np.float32(3.0)
    hi, lo = split_tf32(x)
    assert np.array_equal(tf32_rn(hi), hi) and np.array_equal(tf32_rn(lo), lo)
    resid = np.abs(x.astype(np.float64) - hi - lo.astype(np.float64))
    assert np.all(resid <= 2.0 ** -22 * np.abs(x.astype(np.float64)))
    bf = torch.from_numpy(x).bfloat16().float().numpy()
    assert np.array_equal(tf32_rn(bf), bf)


def _rz_sum(parts, fresh):
    """f32 sum of the float64 `parts`, one per MMA: each added into the
    accumulator and rounded toward zero, as the tensor cores do (a chain), or
    (fresh) each rounded toward zero alone and added round-to-nearest."""
    acc = np.zeros(parts[0].shape, np.float32)
    for x in parts:
        acc = _f32(acc.astype(np.float64) + _rz(x)) if fresh else _rz(acc.astype(np.float64) + x)
    return acc


def test_fresh_mma_accumulators_cut_the_lean_of_dk():
    """Why K10dkv takes dP' and its hi products one MMA at a time: with
    each MMA's sum rounded toward zero (an exact sum rounded once, a
    lenient model of the card), dK built in chains leans toward zero by a
    sizeable share of its error, which adds up coherently over positions (on
    the card it moved train_dense's wk gradient past its bound); fresh
    accumulators joined round-to-nearest leave well under half that lean.
    One causal head at T 512, head_dim 64, 32-row query tiles, p exact."""
    t, d = 512, 64
    rng = np.random.default_rng(1)
    scale = np.float32(1 / np.sqrt(d))
    bf = lambda x: torch.from_numpy(x.astype(np.float32)).bfloat16().float().numpy()  # noqa: E731
    q = rng.standard_normal((t, d)).astype(np.float32)
    k, v = bf(rng.standard_normal((t, d))), bf(rng.standard_normal((t, d)))
    do = rng.standard_normal((t, d)).astype(np.float32)
    f = np.float64
    live = np.tril(np.ones((t, t), bool))
    s64 = np.where(live, (q.astype(f) @ k.T.astype(f)) * float(scale), -np.inf)
    p64 = np.exp(s64 - s64.max(1, keepdims=True))
    p64 /= p64.sum(1, keepdims=True)
    delta = (do.astype(f) * (p64 @ v.astype(f))).sum(1).astype(np.float32)
    dob, p = bf(do), _f32(p64)
    dk64 = ((p64 * (dob.astype(f) @ v.T.astype(f) - delta[:, None]) * float(scale)).T
            @ q.astype(f))
    qh, ql = split_tf32(q)

    def dk(fresh):
        dp = _rz_sum([dob[:, j:j + 16].astype(f) @ v[:, j:j + 16].T.astype(f)
                      for j in range(0, d, 16)], fresh)          # one bf16 MMA per 16 d
        sh, sl = split_tf32(_f32(_f32(p * _f32(dp - delta[:, None])) * scale).T.copy())
        out = np.zeros((t, d), np.float32)
        for i0 in range(0, t, DKV_BQ):
            cols = [slice(i0 + j, i0 + j + 8) for j in range(0, DKV_BQ, 8)]
            hh = _rz_sum([sh[:, c].astype(f) @ qh[c].astype(f) for c in cols], fresh)
            sm = _rz_sum([x for c in cols for x in (sh[:, c].astype(f) @ ql[c].astype(f),
                                                     sl[:, c].astype(f) @ qh[c].astype(f))],
                         False)
            out = _f32(out + _f32(hh + sm))
        return out

    top = np.abs(dk64).max()

    def lean(x):        # mean error along the sign of the exact value
        return float(np.mean((x - dk64) * np.sign(dk64))) / top

    def rms(x):
        return float(np.sqrt(np.mean((x - dk64) ** 2))) / top
    chain, fresh = dk(False), dk(True)
    print(f"dK lean / rms of max|dK|: chains {lean(chain):.3g} / {rms(chain):.3g}, fresh "
          f"{lean(fresh):.3g} / {rms(fresh):.3g}")
    assert lean(chain) < -0.25 * rms(chain)
    assert abs(lean(fresh)) < 0.5 * abs(lean(chain))
    assert rms(fresh) < rms(chain)
