"""K1 / K5's launch plan (ops/qmatmul.py i8_plan) and a torch model of the
kernel's arithmetic (csrc/qmatmul_i8.cu), on the CPU.

The plan is checked at the chip smoke's shapes (TinyLlama-1.1B and
Llama-2-7B projections at M = 1..32) and the GPU tests': every output row in
exactly one tile of one stage of one block, each tile's 128-byte segments in
exactly one part (so its quant blocks cover K once), at most 16 warps a
stage, shared memory within the H100's limit, and the rules that choose the
forms (n8 tiles by M, self quantization by M * K, L2-read activations and
8-row tiles only where the staged form does not fit).

The model repeats the kernel's order: per block of the grid, per stage, per
tile and part, a fresh int32 dot per quant block, acc = fma(float(c), xs * d,
acc) in f32 over the part's blocks in order, then the parts added in order.
On seeded numpy inputs it is held to the JAX package's `_q4_matmul_i8` /
`_q8_matmul_i8` (qmatmul_pallas on its int8 tier, interpret mode) and to the
port's plain version within 1e-5 * max|y| (only the f32 sum over blocks
differs), and to a float64 evaluation of the same int8 function within the
same bound, its rms error at most 2x the plain version's. The fma is taken
in float64 and rounded to f32 (a double rounding the card does not make: a
difference of an ulp at most, far inside the bound). The greedy head's
reduction (first index on ties within a stage, strictly greater across
stages and blocks) is modelled on the same plan and must give np.argmax's
first index, ties included.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zgml_tpu.ops.qmatmul import qmatmul_greedy_pallas, qmatmul_pallas
from zgml_tpu.quant.repack import quantize_weight

from zgml_tpu_torch.ops import decode_plan
from zgml_tpu_torch.ops.qmatmul import (I8_SELF_MAX_MK, I8_TILE, I8_WARPS, _i8_split_plan,
                                        i8_block_tiles, i8_groups, i8_ints, i8_nt,
                                        i8_part_segments, i8_parts, i8_piece, i8_piece_align,
                                        i8_plan, i8_scratch_bytes, i8_stages, qmatmul_i8_ref,
                                        quantize_act_ref)
from zgml_tpu_torch.quant import packed
from zgml_tpu_torch.quant.packed import QS_BLOCK_BYTES

torch.set_num_threads(1)

SMS = 132                    # the H100's SM count
TINY = [(2560, 2048), (2048, 2048), (11264, 2048), (2048, 5632), (32000, 2048)]
SEVEN_B = [(12288, 4096), (4096, 4096), (22016, 4096), (4096, 11008), (32000, 4096)]
GPU_TESTS = [(96, 64), (300, 576), (2560, 2048), (2048, 5632), (11264, 2048), (1000, 512),
             (64, 64)]
SHAPES = [(n, k, kind) for n, k in TINY for kind in ("q4_0", "q8_0")] + \
         [(n, k, "q4_0") for n, k in SEVEN_B] + \
         [(n, k, kind) for n, k in GPU_TESTS for kind in ("q4_0", "q8_0")]
ROWS = (1, 2, 4, 5, 8, 9, 16, 17, 31, 32)
# rows no 8-row tile of whole rows holds a slot of (Q8_0 from k 27,040, Q4_0
# from 51,072; 70B's d_ff is 28,672) at some M: the K-split form
SPLIT_SHAPES = [(8192, 27040, "q8_0"), (8192, 28672, "q8_0"), (1000, 28672, "q8_0"),
                (8192, 51072, "q4_0"), (8192, 57344, "q4_0")]


def _tile_bytes(k, kind, tr):
    return tr * (k // 32) * (QS_BLOCK_BYTES[kind] + 2)


def _fits(m, k, kind, tr, self_q, xg, stages_least, plan):
    """Whether the staged areas of a mode leave `stages_least` slots of one tile."""
    nb, mx = k // 32, 8 * i8_nt(m)
    al = lambda b: -(-b // 128) * 128
    areas = ((al(m * k * 4) if self_q else 0) + (0 if xg else al(m * k) + al(nb * mx * 4))
             + 256)
    slot = al(_tile_bytes(k, kind, tr))
    part1 = I8_WARPS * I8_TILE * (1 if m == 1 else mx) * 4
    areas += 2 * part1 if mx <= 16 else 0 if slot >= part1 else part1
    per_block = -(-(-(-plan.tiles * plan.tr // tr)) // plan.grid)
    need = min(stages_least, per_block)
    return (decode_plan.SMEM_LIMIT - decode_plan.HEADER_BYTES - areas) // slot >= need


@pytest.mark.parametrize("n,k,kind", SHAPES)
def test_plan_covers_rows_and_k(n, k, kind):
    for m in ROWS:
        plan = i8_plan(m, n, k, kind, SMS)
        seen = np.zeros(n, np.int32)
        nxt = 0
        for b in range(plan.grid):
            t0, t1 = i8_block_tiles(plan, b)
            assert t0 == nxt                         # contiguous, in block order
            nxt = t1
            stages = i8_stages(plan, b)
            assert len(stages) == -(-(t1 - t0) // plan.S)
            for u, st in stages:
                assert 1 <= st <= plan.S and i8_parts(plan, st) * i8_groups(plan.nt) * st <= I8_WARPS
                seen[u * plan.tr:min((u + st) * plan.tr, n)] += 1
                segs = [sg for p in range(i8_parts(plan, st))
                        for sg in i8_part_segments(plan, st, p)]
                assert segs == list(range(plan.nseg))    # each segment once, in order
        assert nxt == plan.tiles == -(-n // plan.tr)
        assert np.all(seen == 1), f"m {m}: rows not covered exactly once"
        bps = 128 // QS_BLOCK_BYTES[kind]
        assert plan.nseg == -(-(k // 32) // bps)          # segments cover the quant blocks


@pytest.mark.parametrize("n,k,kind", SHAPES)
def test_plan_fits_shared_memory(n, k, kind):
    for m in ROWS:
        plan = i8_plan(m, n, k, kind, SMS)
        nb, mx = k // 32, 8 * plan.nt
        assert plan.smem_bytes <= decode_plan.SMEM_LIMIT
        assert plan.slot_bytes % 128 == 0 and plan.slot_bytes >= plan.S * _tile_bytes(
            k, kind, plan.tr)
        assert 1 <= plan.stages <= decode_plan.MAX_STAGES
        assert plan.xin_off == decode_plan.HEADER_BYTES + plan.stages * plan.slot_bytes
        assert plan.xf_off >= plan.xin_off + (m * k * 4 if plan.self_q else 0)
        assert plan.xs_off >= plan.xf_off + (0 if plan.xg else m * k)
        assert plan.part_off >= plan.xs_off + (0 if plan.xg else nb * mx * 4)
        part1 = I8_WARPS * I8_TILE * (1 if m == 1 else mx) * 4
        assert plan.pis == (plan.nt == 4 and plan.slot_bytes >= part1)
        assert plan.red_off == plan.part_off + (0 if plan.pis else part1 * (
            2 if plan.nt <= 2 else 1))
        assert plan.smem_bytes >= plan.red_off + I8_WARPS * 8
        ints = i8_ints(plan)
        assert len(ints) == 17 and ints[0] == SMS and ints[13] == plan.smem_bytes
        assert i8_scratch_bytes(plan, 1, k, greedy=True) > i8_scratch_bytes(plan, 1, k)


@pytest.mark.parametrize("n,k,kind", SHAPES)
def test_plan_forms_follow_the_rules(n, k, kind):
    for m in ROWS:
        plan = i8_plan(m, n, k, kind, SMS)
        assert plan.nt == (1 if m <= 8 else 2 if m <= 16 else 4)
        if plan.self_q:
            assert m * k <= I8_SELF_MAX_MK and not plan.xg
        elif m * k <= I8_SELF_MAX_MK:      # self quantization did not fit
            assert not _fits(m, k, kind, plan.tr, True, False, 2, plan)
        if plan.xg:                        # the staged int8 rows did not fit
            assert not _fits(m, k, kind, plan.tr, False, False, 2, plan)
        if plan.tr == I8_TILE // 2:        # no mode fits two 16-row slots
            assert not _fits(m, k, kind, I8_TILE, False, True, 2, plan)
        assert plan.kc == 1                # whole rows wherever they fit


def _units(plan, b):
    """(tile, piece) of each stage of block b."""
    return [(u // plan.kc, u % plan.kc) for u, _ in i8_stages(plan, b)]


@pytest.mark.parametrize("n,k,kind", SPLIT_SHAPES)
def test_split_plan_covers_rows_and_k(n, k, kind):
    """Every (output row, quant block) in exactly one part of one stage of
    one block; pieces on 8-block bounds where k / 32 is a multiple of 8; a
    stage of the K-split form is one unit, within the slot; every warp count
    and the shared memory within the H100's."""
    nb, bps = k // 32, 128 // QS_BLOCK_BYTES[kind]
    for m in ROWS:
        plan = i8_plan(m, n, k, kind, SMS)
        if plan.kc == 1:                 # whole rows fit at this M (a ring of one slot)
            assert (kind, k, m >= 17) in (("q8_0", 27040, True), ("q4_0", 51072, True))
            continue
        assert plan.S == 1 and plan.tr == I8_TILE and plan.smem_bytes <= decode_plan.SMEM_LIMIT
        assert plan.xg and not plan.self_q   # x from L2 (the kernel's SPLIT instantiations)
        assert 2 <= plan.stages <= decode_plan.MAX_STAGES
        assert not _fits(m, k, kind, I8_TILE // 2, False, True, 1, plan)   # no whole-row form
        g = i8_piece_align(nb)
        seen = np.zeros((n, nb), np.int32)
        for b in range(plan.grid):
            for tile, j in _units(plan, b):
                b0, nbc = i8_piece(plan, nb, j)
                assert b0 % g == 0 and nbc % g == 0 and nbc > 0
                assert plan.slot_bytes >= I8_TILE * nbc * (QS_BLOCK_BYTES[kind] + 2)
                nseg = -(-nbc * QS_BLOCK_BYTES[kind] // 128)
                assert nseg <= plan.nseg
                P = i8_parts(plan, 1, nseg)
                assert P * i8_groups(plan.nt) <= I8_WARPS
                rows = slice(tile * I8_TILE, min((tile + 1) * I8_TILE, n))
                for p in range(P):
                    for sg in i8_part_segments(plan, 1, p, nseg):
                        seen[rows, b0 + sg * bps:b0 + min((sg + 1) * bps, nbc)] += 1
        assert np.all(seen == 1), f"m {m}: a (row, block) not covered exactly once"
        assert i8_ints(plan)[16] == plan.kc and len(i8_ints(plan)) == 17
        assert i8_scratch_bytes(plan, m, k, n=n) >= i8_scratch_bytes(plan, m, k) + \
            plan.kc * m * n * 4


def test_split_plan_at_the_70b_shapes():
    """The shapes that raised before: K1q8 on a 70B w_down at M 1 and 32, and
    K1q4 from k 51,072."""
    for m in (1, 32):
        plan = i8_plan(m, 8192, 28672, "q8_0", SMS)
        assert plan.kc > 1 and plan.stages >= 2
    assert i8_plan(1, 8192, 51072, "q4_0", SMS).kc > 1
    assert i8_plan(1, 8192, 27040, "q8_0", SMS).kc > 1


def test_plan_forms_at_the_model_widths():
    """The forms the smoke's cases take on the H100."""
    tiny_wqkv = i8_plan(32, 2560, 2048, "q4_0", SMS)
    assert (tiny_wqkv.self_q, tiny_wqkv.xg, tiny_wqkv.tr, tiny_wqkv.nt) == (False, False, 16, 4)
    head = i8_plan(1, 32000, 2048, "q4_0", SMS)
    assert (head.self_q, head.xg, head.S) == (True, False, 4)     # 16 warps: 4 tiles of 8 segs
    assert i8_plan(1, 32000, 4096, "q4_0", SMS).S == 2            # 2 tiles of 16 segments
    assert i8_plan(32, 4096, 11008, "q4_0", SMS).xg
    seven_wqkv = i8_plan(32, 12288, 4096, "q4_0", SMS)            # partial sums in the slot
    assert seven_wqkv.pis and not seven_wqkv.xg
    assert i8_plan(1, 4096, 11008, "q8_0", SMS).tr == 8
    with pytest.raises(ValueError, match="rows"):
        i8_plan(33, 64, 64, "q4_0", SMS)


# -- the model of the kernel's arithmetic ------------------------------------------

def _part_sums(xq, xs, lv, d, rows, _b0, parts):
    """A tile's sums over `parts` (lists of quant blocks, in order): per part
    acc = fma(float(c), xs * d, acc) from 0 over its blocks, the parts added
    in order -> f32 [rows, M]."""
    v = None
    for blks in parts:
        acc = torch.zeros((rows.stop - rows.start, xq.shape[0]), dtype=torch.float32)
        for blk in blks:
            c = lv[rows, blk] @ xq[:, blk].T                     # exact int dots
            sd = xs[:, blk][None, :] * d[rows, blk][:, None]     # f32 product
            acc = (c.double() * sd.double() + acc.double()).float()
        v = acc if v is None else v + acc
    return v


def kernel_model(x: torch.Tensor, w: packed.PackedWeight, plan) -> torch.Tensor:
    """y f32 [M, N] in the kernel's order on `plan` (see the module); the
    K-split form sums each (tile, piece) unit as a tile, then each output's
    pieces in piece order from 0."""
    m, k = x.shape
    nb = k // 32
    bps = 128 // QS_BLOCK_BYTES[w.kind]
    xq, xs = quantize_act_ref(x)
    xq = xq.to(torch.int64).view(m, nb, 32)
    lv = w.levels().to(torch.int64)                 # [N, nb, 32]
    d = w.d.to(torch.float32)
    y = torch.zeros((m, w.n), dtype=torch.float32)
    if plan.kc > 1:
        ypart = torch.zeros((plan.kc, m, w.n), dtype=torch.float32)
        for b in range(plan.grid):
            for tile, j in _units(plan, b):
                rows = slice(tile * plan.tr, min((tile + 1) * plan.tr, w.n))
                b0, nbc = i8_piece(plan, nb, j)
                nseg = -(-nbc * QS_BLOCK_BYTES[w.kind] // 128)
                parts = [[b0 + blk for sg in i8_part_segments(plan, 1, p, nseg)
                          for blk in range(sg * bps, min((sg + 1) * bps, nbc))]
                         for p in range(i8_parts(plan, 1, nseg))]
                ypart[j][:, rows] = _part_sums(xq, xs, lv, d, rows, b0, parts).T
        for j in range(plan.kc):
            y = y + ypart[j]
        return y
    for b in range(plan.grid):
        for u, st in i8_stages(plan, b):
            for tl in range(st):
                r0 = (u + tl) * plan.tr
                rows = slice(r0, min(r0 + plan.tr, w.n))
                if r0 >= w.n:
                    continue
                parts = [[blk for sg in i8_part_segments(plan, st, p)
                          for blk in range(sg * bps, min((sg + 1) * bps, nb))]
                         for p in range(i8_parts(plan, st))]
                y[:, rows] = _part_sums(xq, xs, lv, d, rows, 0, parts).T
    return y


def greedy_model(y: torch.Tensor, plan) -> int:
    """K5's reduction of y [N] on `plan`: per stage the warps' candidates
    (lowest index on ties), folded in warp order with strictly greater, per
    block in stage order, then the blocks in order."""
    best_blocks = []
    for b in range(plan.grid):
        bv, bi = -np.inf, -1
        for u, st in i8_stages(plan, b):
            rows = list(range(u * plan.tr, min((u + st) * plan.tr, y.numel())))
            for w0 in range(0, len(rows), 32):           # a warp's 32 rows
                seg = rows[w0:w0 + 32]
                vals = y[seg]
                top = float(vals.max())
                cand = seg[int(np.flatnonzero(vals.numpy() == top)[0])]
                if bi < 0 or top > bv:
                    bv, bi = top, cand
        best_blocks.append((bv, bi))
    v, i = -np.inf, -1
    for bv, bi in best_blocks:
        if bi >= 0 and (i < 0 or bv > v):
            v, i = bv, bi
    return i


def _weights(seed, n, k, kind):
    rng = np.random.default_rng(seed)
    jpw = quantize_weight(rng.standard_normal((n, k)).astype(np.float32), kind)
    conv = packed.from_planar_q4_0 if kind == "q4_0" else packed.from_planar_q8_0
    pw = conv(jpw.qvals, jpw.scales, jpw.n, jpw.k, device="cpu")
    jw = dataclasses.replace(jpw, qvals=jnp.asarray(jpw.qvals), scales=jnp.asarray(jpw.scales))
    return rng, jw, pw


@pytest.fixture
def default_flags(monkeypatch):
    """The JAX package's int8 tier (M <= 32), f16 scales (the GGUF scales)."""
    monkeypatch.setenv("ZGML_TPU_SCALES", "f16")
    monkeypatch.delenv("ZGML_TPU_I8DOT", raising=False)


@pytest.mark.parametrize("kind", ["q4_0", "q8_0"])
@pytest.mark.parametrize("m,n,k,sms", [(1, 96, 64, 4), (5, 300, 576, 3), (9, 160, 512, 5),
                                       (32, 200, 1024, 4), (17, 128, 256, 132)])
def test_model_matches_jax_plain_and_float64(default_flags, kind, m, n, k, sms):
    rng, jw, pw = _weights(m * 7 + n, n, k, kind)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[0, :32] = 0.0                                  # an all-zero block: s = 0
    plan = i8_plan(m, n, k, kind, sms)
    xt = torch.from_numpy(x)
    got = kernel_model(xt, pw, plan).numpy()
    jax_y = np.asarray(qmatmul_pallas(jnp.asarray(x), jw))
    plain = qmatmul_i8_ref(xt, pw).numpy()
    xq, xs = quantize_act_ref(xt)
    exact = ((xq.double().view(m, -1, 32) * xs.double()[..., None]).view(m, k)
             @ pw.dequant().double().T).numpy()
    bound = 1e-5 * np.max(np.abs(exact))
    for ref in (jax_y, plain, exact):
        assert np.max(np.abs(got - ref)) <= bound
    rms = np.sqrt(np.mean((got - exact) ** 2))
    rms_plain = np.sqrt(np.mean((plain - exact) ** 2))
    assert rms <= 2.0 * rms_plain + 1e-30


@pytest.mark.parametrize("kind", ["q4_0", "q8_0"])
@pytest.mark.parametrize("m,n,k,sms,kc", [(1, 96, 512, 4, 2), (5, 300, 1024, 3, 3),
                                          (32, 200, 800, 4, 4), (17, 64, 2048, 132, 5)])
def test_split_model_matches_jax_plain_and_float64(default_flags, kind, m, n, k, sms, kc):
    """The K-split form's order (each piece's parts, the pieces in order) at
    small shapes, the plan built at kc pieces: within 1e-5 * max|y| of the
    JAX int8 tier, the plain version and float64, rms at most 2x the plain
    version's (k 800: 25 blocks, pieces on single-block bounds)."""
    rng, jw, pw = _weights(m * 11 + n + kc, n, k, kind)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[0, :32] = 0.0
    plan = _i8_split_plan(m, n, k, kind, sms, kc_least=kc)
    assert plan.kc == kc
    xt = torch.from_numpy(x)
    got = kernel_model(xt, pw, plan).numpy()
    jax_y = np.asarray(qmatmul_pallas(jnp.asarray(x), jw))
    plain = qmatmul_i8_ref(xt, pw).numpy()
    xq, xs = quantize_act_ref(xt)
    exact = ((xq.double().view(m, -1, 32) * xs.double()[..., None]).view(m, k)
             @ pw.dequant().double().T).numpy()
    bound = 1e-5 * np.max(np.abs(exact))
    for ref in (jax_y, plain, exact):
        assert np.max(np.abs(got - ref)) <= bound
    rms = np.sqrt(np.mean((got - exact) ** 2))
    assert rms <= 2.0 * np.sqrt(np.mean((plain - exact) ** 2)) + 1e-30


@pytest.mark.parametrize("kind", ["q4_0", "q8_0"])
@pytest.mark.parametrize("n,k,sms", [(96, 64, 4), (1000, 512, 7), (320, 256, 132)])
def test_greedy_model_matches_jax(default_flags, kind, n, k, sms):
    rng, jw, pw = _weights(n + k, n, k, kind)
    x = rng.standard_normal((1, k)).astype(np.float32)
    plan = i8_plan(1, n, k, kind, sms)
    y = kernel_model(torch.from_numpy(x), pw, plan)[0]
    tok = greedy_model(y, plan)
    assert tok == int(np.argmax(y.numpy()))
    jax_tok = int(np.asarray(qmatmul_greedy_pallas(jnp.asarray(x), jw)).reshape(-1)[0])
    top2 = np.sort(y.numpy())[-2:]
    if top2[1] - top2[0] > 1e-5 * np.max(np.abs(y.numpy())):
        assert tok == jax_tok


@pytest.mark.parametrize("n,sms,at", [(64, 4, [0, 63]), (300, 3, [5, 7, 299]),
                                      (1000, 7, [999, 500, 3]), (96, 4, list(range(96)))])
def test_greedy_reduction_takes_the_first_index_on_ties(n, sms, at):
    """Equal maxima in one warp, across warps, stages and blocks: the first."""
    plan = i8_plan(1, n, 256, "q4_0", sms)
    y = torch.from_numpy(np.random.default_rng(n).uniform(-1, 0, n).astype(np.float32))
    y[at] = 2.0
    assert greedy_model(y, plan) == min(at) == int(np.argmax(y.numpy()))
