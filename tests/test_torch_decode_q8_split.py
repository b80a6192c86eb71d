"""K8's one-launch algorithm (csrc/decode_attn.cu decode_q8_kernel), emulated
in numpy on the CPU, against the plain version of its plan.

The card runs the kernel; this file holds the arithmetic of its plan where
the CPU can reach it: a row's keys cut into n_split parts of whole units
(32-key groups, or JAX blocks of attention.k8_block(S) keys in the
ZGML_TPU_ATTN_I8PV mode; decode_plan.decode_split_keys), a part walked in
steps (256 keys, or one JAX block), a step's groups dealt to 4 warps (a part
of fewer than 4 groups splits its query heads over the warps), each warp its
own running max and sums (I8PV: the block's max of the scores and of p *
v_scale taken across the warps, p quantized against the block's max, the
integer P.V per warp), the warps merged in warp order and the parts in part
order. Held to attention.decode_attention_q8_ref(i8pv, split=n_split)
within 1e-5 * max|o| (f32 sums in another order), or in the I8PV mode
2 x the plain version's own move when its score scale moves by 2^-20 or
2^-18, the larger: numpy's exp and torch's may put p * v_scale / psc on
the two sides of a half, which moves a level (a flip). A kv_len 0 row
gives 0.
"""
import numpy as np
import pytest
import torch

from zgml_tpu_torch.ops import attention, decode_plan as dp
from zgml_tpu_torch.quant.kv_cache import quantize_columns

RTOL = 1e-5
FLIP_EPS = (2.0 ** -20, -2.0 ** -20, 2.0 ** -18, -2.0 ** -18)
SMS = 132                  # the H100's SM count (decode_plan.sm_count on the card)
WARPS, GROUP, STEP = dp.DECODE_WARPS, dp.DECODE_GROUP, 256


def _warp_state(n_rep, d):
    return dict(m=np.full(n_rep, -np.inf, np.float32), l=np.zeros(n_rep, np.float32),
                acc=np.zeros((n_rep, d), np.float32))


def _part(qq, qs, k, ks, v, vs, k0, k1, bs, i8pv, scale):
    """One split's partial (max, sum, unnormalised o) per query head over
    keys [k0, k1), the warps of the kernel merged in warp order."""
    n_rep, d = qq.shape
    ck = bs if i8pv else STEP
    gt = -(-(k1 - k0) // GROUP)
    hs = 1 if gt >= WARPS else WARPS // gt
    per = -(-n_rep // hs)
    heads = [range(min(n_rep, w % hs * per), min(n_rep, w % hs * per + per))
             for w in range(WARPS)]
    warps = [_warp_state(n_rep, d) for _ in range(WARPS)]
    for c0 in range(k0, k1, ck):
        c1 = min(c0 + ck, k1)
        keys, sc = [], []
        for w in range(WARPS):
            groups = [w // hs + g * (WARPS // hs) for g in range(2)]
            kw = [j for g in groups if len(heads[w]) and c0 + g * GROUP < c1
                  for j in range(c0 + g * GROUP, min(c0 + (g + 1) * GROUP, c1))]
            keys.append(np.asarray(kw, np.int64))
            dots = (qq.astype(np.int32) @ k[kw].astype(np.int32).T).astype(np.float32)
            sc.append(dots * ((qs[:, None] * ks[kw][None, :]) * scale))
        if i8pv:   # the block's maxima across the warps that hold a head
            bm = np.full(n_rep, -np.inf, np.float32)
            for w in range(WARPS):
                for r in heads[w]:
                    if len(keys[w]):
                        bm[r] = max(bm[r], sc[w][r].max())
            pvs, pmax = [], np.zeros(n_rep, np.float32)
            for w in range(WARPS):
                st = warps[w]
                pvs.append(np.zeros((n_rep, len(keys[w])), np.float32))
                for r in heads[w]:
                    mn = max(st["m"][r], bm[r])
                    alpha = np.exp(np.float32(st["m"][r] - mn))
                    p = np.exp(sc[w][r] - mn).astype(np.float32)
                    st["l"][r] = st["l"][r] * alpha + p.sum(dtype=np.float32)
                    st["acc"][r] *= alpha
                    st["m"][r] = mn
                    pvs[w][r] = p * vs[keys[w]]
                    pmax[r] = max(pmax[r], pvs[w][r].max(initial=0.0))
            psc = (pmax / np.float32(127)).astype(np.float32)
            pinv = np.where(psc > 0, np.float32(1) / np.where(psc > 0, psc, 1), 0).astype(
                np.float32)
            for w in range(WARPS):
                for r in heads[w]:
                    pq = np.rint(pvs[w][r] * pinv[r]).astype(np.int64)
                    o_i = pq @ v[keys[w]].astype(np.int64)          # exact
                    warps[w]["acc"][r] += o_i.astype(np.float32) * psc[r]
        else:      # each warp its own online softmax
            for w in range(WARPS):
                if not len(keys[w]):
                    continue
                st = warps[w]
                for r in heads[w]:
                    mn = max(st["m"][r], sc[w][r].max())
                    alpha = np.exp(np.float32(st["m"][r] - mn))
                    p = np.exp(sc[w][r] - mn).astype(np.float32)
                    st["l"][r] = st["l"][r] * alpha + p.sum(dtype=np.float32)
                    st["acc"][r] = st["acc"][r] * alpha + (p * vs[keys[w]]) @ v[keys[w]].astype(
                        np.float32)
                    st["m"][r] = mn
    mx, den, num = (np.full(n_rep, -np.inf, np.float32), np.zeros(n_rep, np.float32),
                    np.zeros((n_rep, d), np.float32))
    for r in range(n_rep):
        live = [st for w, st in enumerate(warps) if r in heads[w] and st["l"][r] > 0]
        mx[r] = max(st["m"][r] for st in live)
        for st in live:
            e = np.exp(np.float32(st["m"][r] - mx[r]))
            num[r] += e * st["acc"][r]
            den[r] += e * st["l"][r]
    return mx, den, num


def _k8_emulated(q, k, ks, v, vs, lens, n_split, i8pv):
    """K8's algorithm: q [B, Hq, D] f32, k / v [B, Hkv, S, D] int8 levels, ks
    / vs [B, Hkv, S] f32 -> o [B, Hq, D]."""
    b_, hq, d = q.shape
    hkv, s_len = k.shape[1], k.shape[2]
    n_rep, scale = hq // hkv, np.float32(1.0 / d ** 0.5)
    bs = attention.k8_block(s_len)
    qq, qs = (t.numpy() for t in quantize_columns(torch.from_numpy(q)))
    o = np.zeros_like(q)
    for b in range(b_):
        for hk in range(hkv):
            hh = slice(hk * n_rep, (hk + 1) * n_rep)
            parts = []
            for sp in range(n_split):
                k0, k1 = dp.decode_split_keys(int(lens[b]), s_len, n_split, sp,
                                              bs if i8pv else GROUP)
                if k0 < k1:
                    parts.append(_part(qq[b, hh], qs[b, hh], k[b, hk], ks[b, hk], v[b, hk],
                                       vs[b, hk], k0, k1, bs, i8pv, scale))
            if not parts:
                continue
            mx = np.max([pt[0] for pt in parts], axis=0)
            num = sum(np.exp(pt[0] - mx)[:, None] * pt[2] for pt in parts)
            den = sum(np.exp(pt[0] - mx) * pt[1] for pt in parts)
            o[b, hh] = num / den[:, None]
    return o


CASES = [
    # hkv, n_rep, hd, S, kv_len: TinyLlama's heads at the smoke's batch and its
    # JAX-block boundary batch; Llama-2-7B's head dim with n_rep 1; blocks of
    # 128 (S 384 and the padded S 300) and one block of S 200
    (4, 8, 64, 2048, [1, 200, 2047, 1000]),
    (4, 8, 64, 2048, [256, 257, 513, 0]),
    (2, 1, 128, 2048, [200, 2047]),
    (2, 4, 128, 384, [333, 129]),
    (2, 8, 32, 300, [300, 97]),
    (2, 2, 16, 200, [200, 31]),
]


@pytest.mark.parametrize("i8pv", [False, True], ids=["f32p", "i8pv"])
@pytest.mark.parametrize("hkv,n_rep,hd,s_len,kv_len", CASES)
def test_k8_algorithm_matches_the_plain_version_of_its_plan(hkv, n_rep, hd, s_len, kv_len, i8pv):
    rng = np.random.default_rng(hd + n_rep + s_len)
    b = len(kv_len)
    lens = np.asarray(kv_len, np.int32)
    q = rng.standard_normal((b, hkv * n_rep, hd)).astype(np.float32)
    k, v = (rng.integers(-127, 128, (b, hkv, s_len, hd), dtype=np.int8) for _ in range(2))
    ks, vs = (rng.uniform(0.01, 0.02, (b, hkv, s_len)).astype(np.float32) for _ in range(2))
    n_split = attention.decode_q8_splits(b, hkv, s_len, hd, SMS, i8pv)
    got = _k8_emulated(q, k, ks, v, vs, lens, n_split, i8pv)
    args = (torch.from_numpy(q)[:, :, None], *(torch.from_numpy(t) for t in (k, ks, v, vs)),
            torch.from_numpy(lens))

    def plain(scale=None):
        return attention.decode_attention_q8_ref(*args, i8pv=i8pv, split=n_split,
                                                 scale=scale)[:, :, 0].numpy()
    want = plain()
    mx = np.abs(want).max()
    move = max(np.abs(plain((1 + e) / hd ** 0.5) - want).max() for e in FLIP_EPS) if i8pv else 0
    assert np.abs(got - want).max() <= max(RTOL * mx, 2 * move)
    for row, n in enumerate(kv_len):
        if n == 0:
            assert not got[row].any() and not want[row].any()


@pytest.mark.parametrize("hkv,n_rep,hd,s_len,kv_len", CASES)
def test_k8_i8pv_splits_take_whole_jax_blocks(hkv, n_rep, hd, s_len, kv_len):
    """The I8PV plan: n_split at most the cache's JAX blocks, every part
    starting on a block, the parts covering each row's keys once; and the
    plan's function (each part's running max from its first block) within
    2 x the flip move, or 1e-5 * max|o|, of JAX's unsplit one."""
    b = len(kv_len)
    bs = attention.k8_block(s_len)
    n_split = attention.decode_q8_splits(b, hkv, s_len, hd, SMS, True)
    assert 1 <= n_split <= min(dp.DECODE_MAX_SPLIT, -(-s_len // bs))
    for n in kv_len:
        keys = [dp.decode_split_keys(n, s_len, n_split, sp, bs) for sp in range(n_split)]
        assert [j for k0, k1 in keys for j in range(k0, k1)] == list(range(min(n, s_len)))
        assert all(k0 % bs == 0 for k0, k1 in keys if k1 > k0)
    rng = np.random.default_rng(s_len + hd)
    q = torch.from_numpy(rng.standard_normal((b, hkv * n_rep, 1, hd)).astype(np.float32))
    k, v = (torch.from_numpy(rng.integers(-127, 128, (b, hkv, s_len, hd), dtype=np.int8))
            for _ in range(2))
    ks, vs = (torch.from_numpy(rng.uniform(0.01, 0.02, (b, hkv, s_len)).astype(np.float32))
              for _ in range(2))
    lens = torch.tensor(kv_len, dtype=torch.int32)

    def plain(split=None, scale=None):
        return attention.decode_attention_q8_ref(q, k, ks, v, vs, lens, i8pv=True, split=split,
                                                 scale=scale)
    want = plain()
    move = max(float((plain(scale=(1 + e) / hd ** 0.5) - want).abs().max()) for e in FLIP_EPS)
    err = float((plain(n_split) - want).abs().max())
    assert err <= max(RTOL * float(want.abs().max()), 2 * move)


def test_k8_splits_at_the_main_shapes():
    """K8's plan at S 2048 on the H100 (two blocks an SM at every head dim):
    TinyLlama-1.1B batch 4 (4 KV heads of 64) 16 splits of 32-key groups,
    8 in the I8PV mode (the cache's 256-key JAX blocks); Llama-2-7B batch 1
    (32 KV heads of 128) 8 in both."""
    assert attention.decode_q8_splits(4, 4, 2048, 64, SMS, False) == 16
    assert attention.decode_q8_splits(4, 4, 2048, 64, SMS, True) == 8
    assert attention.decode_q8_splits(1, 32, 2048, 128, SMS, False) == 8
    assert attention.decode_q8_splits(1, 32, 2048, 128, SMS, True) == 8
