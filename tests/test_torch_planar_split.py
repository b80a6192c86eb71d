"""K6b's tensor-core design (csrc/ffn_planar.cu) and K4's split decode
attention (csrc/decode_attn.cu), held on the CPU before the card sees them.
numpy and torch only.

K6b: an emulation that builds each m16n8k8 operand the way the kernel's
lanes do (lane g, t: word t of rows g and g + 8 of a quant block, its byte
s's low nibble as A column t and its high nibble as column t + 4 of k-step
s; the staged x rows' elements 4t + s and 16 + 4t + s as B rows t and t + 4),
then sums as the kernel does: per quant block the 4 lo and the 4 hi MMAs
(rounded toward zero, as the tensor cores accumulate) into two fresh
accumulators, added, and joined by one fma with the row's scale; the 16 warps as n8
tiles of the M rows times parts of the blocks, a part's blocks in order, the
parts added in order, the chunks in chunk order. The operand mapping gives the block dot exactly on integer
data; at the TinyLlama-1.1B and Llama-2-7B contraction lengths the order
keeps an f32 FMA loop's rms error against float64; the two phases with SwiGLU
match the plain version (ops/ffn.fused_ffn_ref) at a chunked shape.

K4: the kernel's algorithm in numpy f32 (a block per split of
decode_plan.decode_split_keys, a warp per 32-key group with online softmax,
the warps merged in order, the live splits merged in order) against the
plain version (ops/attention.decode_attention_ref) at batch 4 with per-row
kv_len (0, 1, 200, 2047).
"""
import numpy as np
import pytest
import torch

from test_torch_qmatmul_split import _rz, tf32_rn
from zgml_tpu_torch.ops import decode_plan as dp
from zgml_tpu_torch.ops.attention import decode_attention_ref
from zgml_tpu_torch.ops.ffn import fused_ffn_ref
from zgml_tpu_torch.quant.packed import from_nibbles

QK = 32


def _split(x):
    x = np.asarray(x, np.float32)
    hi = tf32_rn(x)
    return hi, tf32_rn(x - hi)


def _mma(acc, a, b):
    return _rz(acc.astype(np.float64) + a.astype(np.float64) @ b.astype(np.float64))


def _operands(qs_blk: np.ndarray, xb: np.ndarray, m_rows: int):
    """The 4 k-steps' A [T, 16, 8] and B [8, 8 * NT] of one quant block as the
    lanes build them: qs_blk [T, 16 rows, 16 bytes], xb [M, 32] (one part of
    the staged block)."""
    nt = dp.planar_nt(m_rows)
    a, b = [], []
    for s in range(4):
        As = np.zeros(qs_blk.shape[:1] + (16, 8), np.float32)
        Bs = np.zeros((8, 8 * nt), np.float32)
        for t in range(4):
            byte = qs_blk[:, :, 4 * t + s].astype(np.int32)       # byte s of word t
            As[:, :, t] = (byte & 15) - 8                          # rows g and g + 8 alike
            As[:, :, t + 4] = (byte >> 4) - 8
            for g in range(8):
                for n in range(nt):
                    m = 8 * n + g
                    if m < m_rows:
                        Bs[t, m] = xb[m, 4 * t + s]
                        Bs[t + 4, m] = xb[m, 16 + 4 * t + s]
        a.append(As)
        b.append(Bs)
    return a, b


def _tiles_emulated(qs: np.ndarray, d: np.ndarray, x: np.ndarray, kc: int, ks: int):
    """The sums of T tiles: qs [T, 16, nblk, 16] bytes, d [T, 16, nblk]
    scales, x [M, K] -> f32 [T, 16, M], in the kernel's order: the 16 warps
    as nt n8 tiles times 16 / nt parts, part q taking blocks q, q + 16 / nt,
    ... of each stage (all n8 tiles at once here: the tiles' sums do not
    meet), the parts added in order."""
    m_rows, k = x.shape
    nblk = k // QK
    hi, lo = _split(x)
    n_t = qs.shape[0]
    nt = dp.planar_nt(m_rows)
    parts = 16 // nt
    tot = None
    for c0 in range(0, nblk, kc):
        nbc = min(kc, nblk - c0)
        part = []
        for q in range(parts):
            run = np.zeros((n_t, 16, 8 * nt), np.float32)
            for s0 in range(0, nbc, ks):
                for bl in range(q, min(ks, nbc - s0), parts):
                    blk = c0 + s0 + bl
                    chains = []
                    for xp in (lo, hi):                    # two fresh chains, then one add
                        acc = np.zeros_like(run)
                        a, b = _operands(qs[:, :, blk], xp[:, blk * QK:(blk + 1) * QK], m_rows)
                        for s in range(4):
                            acc = _mma(acc, a[s], b[s])
                        chains.append(acc)
                    acc = (chains[0] + chains[1]).astype(np.float32)
                    run = (d[:, :, blk, None].astype(np.float64) * acc + run).astype(np.float32)
            part.append(run)
        v = np.zeros_like(part[0])
        for q in range(parts):
            v = (v + part[q]).astype(np.float32)
        tot = v if tot is None else (tot + v).astype(np.float32)
    return tot[:, :, :m_rows]


def _pack(levels: np.ndarray) -> np.ndarray:
    """Q4_0 levels [R, K] (-8..7) -> qs bytes [R, K/32, 16]: byte j holds
    element j in its low nibble and j + 16 in its high one."""
    u = (levels + 8).astype(np.uint8).reshape(levels.shape[0], -1, 32)
    return u[:, :, :16] | (u[:, :, 16:] << 4)


def test_block_operands_give_the_block_dot_exactly():
    """Integer x and levels: the 8 MMAs of a block on the lanes' operands
    are exact, and equal x . levels over the block for each of 16 rows and
    up to 32 rows of x."""
    rng = np.random.default_rng(0)
    for m in (1, 4, 7, 9, 32):
        lev = rng.integers(-8, 8, (16, QK))
        x = rng.integers(-50, 50, (m, QK)).astype(np.float32)
        a, b = _operands(_pack(lev)[None, :, 0], x, m)
        acc = np.zeros((1, 16, 8 * dp.planar_nt(m)), np.float32)
        for s in range(4):
            acc = _mma(acc, a[s], b[s])
        assert np.array_equal(acc[0, :, :m], (lev @ x.T).astype(np.float32))


def _rms(y, exact):
    return float(np.sqrt(np.mean((y.astype(np.float64) - exact) ** 2)))


@pytest.mark.parametrize("k", [2048, 5632, 4096, 11008])
@pytest.mark.parametrize("m", [1, 4, 7, 32])
def test_planar_order_keeps_the_error_of_an_f32_loop(k, m):
    """One 16-row tile at TinyLlama-1.1B's (2048, w_down's 5632) and
    Llama-2-7B's (4096, 11008) contraction lengths, in the plan's chunks and
    stages: the emulated kernel's rms error against float64 is at most an f32
    FMA loop's."""
    rng = np.random.default_rng(k + m)
    plan = dp.planar_plan(m, 2048 if k in (2048, 5632) else 4096, 5632 if k in (2048, 5632)
                          else 11008, 132)
    lev = rng.integers(-8, 8, (16, k))
    d = rng.uniform(0.001, 0.02, (16, k // QK)).astype(np.float16).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    got = _tiles_emulated(_pack(lev)[None], d[None], x, plan.kc, plan.ks)[0]
    w = lev * np.repeat(d, QK, axis=1)
    exact = w.astype(np.float64) @ x.astype(np.float64).T
    loop = np.zeros((16, m), np.float32)
    for j in range(k):
        loop = (loop.astype(np.float64) + w[:, j:j + 1].astype(np.float64) * x[:, j]).astype(
            np.float32)
    assert _rms(got, exact) <= _rms(loop, exact)


@pytest.mark.parametrize("m", [3, 9])
def test_planar_phases_match_the_plain_version(m):
    """d 512, f 1024 in chunks of 16 blocks (gate|up in 1, down in 2): the
    emulated kernel (gate|up tiles of 8 gate and 8 up rows, SwiGLU, then the
    down tiles over act) within 1e-5 * max|y| of fused_ffn_ref."""
    d, f, kc, ks = 512, 1024, 16, 16
    rng = np.random.default_rng(m)
    lev_gu, lev_dn = rng.integers(-8, 8, (2 * f, d)), rng.integers(-8, 8, (d, f))
    d_gu = rng.uniform(0.001, 0.02, (2 * f, d // QK)).astype(np.float16)
    d_dn = rng.uniform(0.001, 0.02, (d, f // QK)).astype(np.float16)
    h = rng.standard_normal((m, d)).astype(np.float32)
    # gate|up: tile t = gate rows 8t..8t+7, then the same up rows
    rows = np.concatenate([np.arange(f).reshape(-1, 8), f + np.arange(f).reshape(-1, 8)], 1)
    qs_gu = _pack(lev_gu)[rows]
    sums = _tiles_emulated(qs_gu, d_gu.astype(np.float32)[rows], h, kc, ks)
    gate, up = sums[:, :8].reshape(f, m), sums[:, 8:].reshape(f, m)
    act = ((gate * (np.float32(1) / (np.float32(1) + np.exp(-gate)))) * up).astype(np.float32)
    rows_dn = np.arange(d).reshape(-1, 16)
    y = _tiles_emulated(_pack(lev_dn)[rows_dn], d_dn.astype(np.float32)[rows_dn],
                        np.ascontiguousarray(act.T), kc, ks).reshape(d, m).T
    gu = from_nibbles((lev_gu + 8).astype(np.uint8), d_gu, "cpu")
    wd = from_nibbles((lev_dn + 8).astype(np.uint8), d_dn, "cpu")
    want = fused_ffn_ref(torch.from_numpy(h), gu, wd).numpy()
    assert np.abs(y - want).max() <= 1e-5 * np.abs(want).max()


# ---- K4 -----------------------------------------------------------------------------

def _decode_emulated(q, k, v, lens, n_split):
    """K4's algorithm in f32: q [B, Hq, D], k / v [B, Hkv, S, D] f32 (bf16
    values) -> o [B, Hq, D]."""
    b_, hq, dd = q.shape
    hkv, s_len = k.shape[1], k.shape[2]
    n_rep, scale = hq // hkv, np.float32(1.0 / dd ** 0.5)
    o = np.zeros_like(q)
    for b in range(b_):
        for hk in range(hkv):
            qg = q[b, hk * n_rep:(hk + 1) * n_rep]
            parts = []
            for sp in range(n_split):
                k0, k1 = dp.decode_split_keys(int(lens[b]), s_len, n_split, sp)
                if k0 == k1:
                    continue
                groups = list(range(k0, k1, dp.DECODE_GROUP))
                warps = []
                for w in range(dp.DECODE_WARPS):
                    m = np.full(n_rep, -np.inf, np.float32)
                    lane_l = np.zeros((n_rep, dp.DECODE_GROUP), np.float32)
                    acc = np.zeros((n_rep, dd), np.float32)
                    for g0 in groups[w::dp.DECODE_WARPS]:
                        g1 = min(g0 + dp.DECODE_GROUP, k1)
                        sc = np.full((n_rep, dp.DECODE_GROUP), -np.inf, np.float32)
                        sc[:, :g1 - g0] = (qg @ k[b, hk, g0:g1].T).astype(np.float32) * scale
                        mn = np.maximum(m, sc.max(1))
                        alpha = np.exp(m - mn).astype(np.float32)
                        p = np.exp(sc - mn[:, None]).astype(np.float32)
                        lane_l = (lane_l * alpha[:, None] + p).astype(np.float32)
                        acc = (acc * alpha[:, None] + p[:, :g1 - g0] @ v[b, hk, g0:g1]).astype(
                            np.float32)
                        m = mn
                    warps.append((m, lane_l.sum(1, dtype=np.float32), acc))
                live = [wp for wp in warps if (wp[1] > 0).all()]
                mx = np.max([wp[0] for wp in live], axis=0)
                num = sum(np.exp(wp[0] - mx)[:, None] * wp[2] for wp in live)
                den = sum(np.exp(wp[0] - mx) * wp[1] for wp in live)
                parts.append((mx, den, num))
            if not parts:
                continue
            mx = np.max([pt[0] for pt in parts], axis=0)
            num = sum(np.exp(pt[0] - mx)[:, None] * pt[2] for pt in parts)
            den = sum(np.exp(pt[0] - mx) * pt[1] for pt in parts)
            o[b, hk * n_rep:(hk + 1) * n_rep] = num / den[:, None]
    return o


@pytest.mark.parametrize("hkv,n_rep,hd", [(4, 8, 64), (2, 4, 128), (2, 1, 16)])
def test_decode_split_algorithm_matches_the_plain_version(hkv, n_rep, hd):
    """Batch 4 with kv_len (0, 1, 200, 2047) over an S 2048 cache, the
    H100's split count: within 1e-5 of decode_attention_ref; kv_len 0 gives 0."""
    rng = np.random.default_rng(hd + n_rep)
    b, s_len = 4, 2048
    lens = np.array([0, 1, 200, 2047], np.int32)
    q = rng.standard_normal((b, hkv * n_rep, hd)).astype(np.float32)
    kv = [torch.from_numpy(rng.standard_normal((b, hkv, s_len, hd)).astype(np.float32))
          .to(torch.bfloat16) for _ in range(2)]
    n_split = dp.decode_splits(b, hkv, s_len, hd, 132)
    got = _decode_emulated(q, *(t.float().numpy() for t in kv), lens, n_split)
    want = decode_attention_ref(torch.from_numpy(q)[:, :, None], *kv,
                                torch.from_numpy(lens))[:, :, 0].numpy()
    assert np.abs(got - want).max() <= 1e-5
    assert not got[0].any()
