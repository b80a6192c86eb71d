"""The launch plans of the weight-streaming decode kernels (K7, K6; ops/
decode_plan.py) and the arithmetic of their dots, on the CPU: torch and
numpy only, no card.

Each plan is checked as the kernels read it (csrc/weight_stream.cuh): every
weight row is copied exactly once (K7's phase A: both rows of each RoPE pair
in one stage), no block's bytes exceed the mean by more than one unit, every
bulk copy's address offset and size are multiples of 16 bytes, the ring plus
the staged rows fit one block's shared memory, and the grid is one block an
SM. The numpy emulation holds a row's summation order in the kernels (lane l
takes blocks l, l + 32, ...; each block in F::elem order, scaled by one fma;
the lanes summed by the xor butterfly) to float64, within the rms error of
a sequential f32 loop, and the exponent trick and the Q4_0 int8 fold to the
integers they replace.
"""
from __future__ import annotations

import itertools

import numpy as np
import pytest

from zgml_tpu_torch.ops import decode_plan as dp
from zgml_tpu_torch.quant.packed import QS_BLOCK_BYTES

SMS = 132
TINY = dict(d=2048, hq=32, hkv=4, hd=64, f=5632)
L7B = dict(d=4096, hq=32, hkv=32, hd=128, f=11008)
KINDS = ("q4_0", "q8_0")

# (d, hq, hkv, hd): TinyLlama-1.1B, Llama-2-7B, the JAX test widths (d 512,
# 576), and every compiled head dim at n_rep 1, 4 and 8
ATTN_SHAPES = ([(TINY["d"], TINY["hq"], TINY["hkv"], TINY["hd"]),
                (L7B["d"], L7B["hq"], L7B["hkv"], L7B["hd"]),
                (512, 8, 2, 64), (576, 9, 3, 64)]
               + [(8 * hd, 8, 8 // n_rep, hd) for hd in range(32, 257, 32) for n_rep in (1, 4, 8)])
FFN_SHAPES = [(TINY["d"], TINY["f"]), (L7B["d"], L7B["f"]), (512, 320), (512, 1024),
              (576, 1536), (576, 320)]


def _rows(ph: dp.Phase, u0: int, u1: int):
    """(segment, first row, rows) of each copy of the units [u0, u1), as the
    producer issues them."""
    for u, c in dp.stages_of(ph, u0, u1):
        row, n = dp.unit_row(ph, u), c * ph.unit_rows
        for s in range(ph.segs):
            yield s, row + s * ph.seg_off, n


def _check_phase(ph: dp.Phase, kind: str, n_rows: int, plan: dp.StreamPlan):
    rq, rd = ph.k // 32 * QS_BLOCK_BYTES[kind], ph.k // 16
    seen = np.zeros(n_rows, np.int64)
    unit_bytes = ph.segs * ph.unit_rows * (rq + rd)
    per_block = []
    for b in range(plan.grid):
        u0, u1 = ph.bounds[b], ph.bounds[b + 1]
        per_block.append((u1 - u0) * unit_bytes)
        for u, c in dp.stages_of(ph, u0, u1):
            rows = c * ph.unit_rows
            assert ph.segs * rows * (rq + rd) <= plan.slot_bytes
            assert ph.segs * rows % dp.ITEM_ROWS == 0            # whole items a stage
            # the stage's layout in its slot: [qs segs][scale segs], 16-byte aligned
            assert (rows * rq) % 16 == 0 and (rows * rd) % 16 == 0
        for s, row, n in _rows(ph, u0, u1):
            assert (row * rq) % 16 == 0 and (n * rq) % 16 == 0    # qs copy
            assert (row * rd) % 16 == 0 and (n * rd) % 16 == 0    # scale copy
            seen[row:row + n] += 1
    assert (seen == 1).all(), "a weight row is copied twice or never"
    assert ph.bounds[0] == 0 and ph.bounds[-1] == ph.units
    assert max(per_block) <= sum(per_block) / plan.grid + unit_bytes


def _check_plan(plan: dp.StreamPlan):
    assert 1 <= plan.grid <= SMS
    assert 1 <= plan.stages <= dp.MAX_STAGES
    assert plan.slot_bytes % dp.SLOT_ALIGN == 0
    assert plan.smem_bytes == dp.HEADER_BYTES + plan.stages * plan.slot_bytes + plan.act_bytes
    assert plan.smem_bytes <= 232_448
    assert len(dp.host_ints(plan)) == dp.PLAN_HEADER + dp.PHASE_INTS * len(plan.phases)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("a_i8,kv8", list(itertools.product((False, True), repeat=2)))
@pytest.mark.parametrize("d,hq,hkv,hd", ATTN_SHAPES)
def test_attn_plan(d, hq, hkv, hd, a_i8, kv8, kind):
    plan = dp.attn_plan(d, hq, hkv, hd, kind, a_i8, kv8, 2048, SMS)
    _check_plan(plan)
    pa, pc = plan.phases
    half = hd // 2
    _check_phase(pa, kind, (hq + 2 * hkv) * hd, plan)
    _check_phase(pc, kind, d, plan)
    # phase A: a stage holds whole RoPE pairs of one head, both rows
    for b in range(plan.grid):
        for s, row, n in _rows(pa, pa.bounds[b], pa.bounds[b + 1]):
            lo = row - s * half
            assert lo % hd + n <= half, "a stage crosses a head"
    assert dp.attn_act_bytes(d, hq, hkv, hd, a_i8, kv8, 2048, SMS) == plan.act_bytes


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m", (1, 5, 8, 32))
@pytest.mark.parametrize("d,f", FFN_SHAPES)
def test_ffn_plan(d, f, m, kind):
    for a_i8 in ((False, True) if kind == "q4_0" else (False,)):
        plan = dp.ffn_plan(m, d, f, kind, a_i8, SMS)
        _check_plan(plan)
        gu, dn = plan.phases
        _check_phase(gu, kind, 2 * f, plan)
        _check_phase(dn, kind, d, plan)
        assert gu.seg_off == f and plan.mr in dp.FFN_GROUPS
        assert dp.ffn_act_bytes(d, f, plan.mr, a_i8) == plan.act_bytes


def _busiest_block_stages(plan: dp.StreamPlan) -> int:
    return max(sum(len(dp.stages_of(ph, ph.bounds[b], ph.bounds[b + 1])) for ph in plan.phases)
               for b in range(plan.grid))


def test_plans_at_the_main_shapes_keep_a_deep_ring():
    """The decode calls of the main paths stream through at least 4 slots,
    or hold a block's whole share in the ring, one block an SM."""
    plans = [dp.attn_plan(s["d"], s["hq"], s["hkv"], s["hd"], kind, a_i8, kv8, 2048, SMS)
             for kind, (a_i8, kv8), s in itertools.product(KINDS, ((False, False), (True, True)),
                                                          (TINY, L7B))]
    plans += [dp.ffn_plan(1, s["d"], s["f"], kind, a_i8, SMS)
              for s, kind, a_i8 in ((TINY, "q4_0", False), (TINY, "q8_0", False),
                                    (L7B, "q4_0", True))]
    for plan in plans:
        assert plan.grid == SMS and plan.mr == 1
        assert plan.stages >= min(4, _busiest_block_stages(plan))


def test_few_units_leave_blocks_empty():
    """Fewer units than blocks (d 64): the extra blocks take empty ranges and
    every row is still copied once."""
    plan = dp.ffn_plan(3, 64, 64, "q4_0", False, SMS)
    _check_plan(plan)
    gu, dn = plan.phases
    assert gu.units < plan.grid
    _check_phase(gu, "q4_0", 128, plan)
    _check_phase(dn, "q4_0", 64, plan)


# ---- the dots' arithmetic --------------------------------------------------------

def _fma32(a, b, c):
    """fmaf in float32: the exact product plus c, rounded once (float64
    holds the product of two float32 exactly)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(
        np.float32)


def _elem_order(kind):
    return ([t // 2 if t % 2 == 0 else 16 + t // 2 for t in range(32)] if kind == "q4_0"
            else list(range(32)))


def _kernel_row_dot(levels, scales, x, kind):
    """One row as the kernels sum it: lane l over blocks l, l + 32, ...,
    each block's 32 products in F::elem order from 0, scaled by d with one
    fma into the lane's sum; then the xor butterfly over the 32 lanes."""
    nb = scales.shape[-1]
    acc = np.zeros(32, np.float32)
    order = _elem_order(kind)
    for b in range(nb):
        lane = b % 32
        s = np.float32(0)
        for j in order:
            s = _fma32(np.float32(levels[b * 32 + j]), np.float32(x[b * 32 + j]), np.float32(s))
        acc[lane] = _fma32(np.float32(s), np.float32(scales[b]), np.float32(acc[lane]))
    off = 16
    while off:
        acc = (acc + acc[np.arange(32) ^ off]).astype(np.float32)
        off //= 2
    return acc[0]


def _sequential_dot(levels, scales, x):
    """The same row as one f32 loop over k (level * d * x, in order)."""
    w = (levels.reshape(-1, 32).astype(np.float32) * scales[:, None].astype(np.float32)).ravel()
    s = np.float32(0)
    for a, b in zip(w, x):
        s = np.float32(s + np.float32(a * b))
    return s


@pytest.mark.parametrize("kind,k", [("q4_0", 2048), ("q8_0", 2048), ("q4_0", 1536)])
def test_row_sum_order_against_float64(kind, k):
    rng = np.random.default_rng(k + len(kind))
    errs_kernel, errs_seq = [], []
    for _ in range(12):
        levels = (rng.integers(-8, 8, k) if kind == "q4_0" else rng.integers(-127, 128, k))
        scales = (rng.random(k // 32) * 0.02 + 0.001).astype(np.float16).astype(np.float32)
        x = rng.standard_normal(k).astype(np.float32)
        exact = float(np.dot((levels.reshape(-1, 32) * scales[:, None].astype(np.float64))
                             .ravel(), x.astype(np.float64)))
        errs_kernel.append(float(_kernel_row_dot(levels, scales, x, kind)) - exact)
        errs_seq.append(float(_sequential_dot(levels, scales, x)) - exact)
    rms_kernel = float(np.sqrt(np.mean(np.square(errs_kernel))))
    rms_seq = float(np.sqrt(np.mean(np.square(errs_seq))))
    assert rms_kernel <= 1.25 * rms_seq + 1e-9


def test_exponent_trick_gives_the_levels_exactly():
    """2^23 + n from the bits, less 2^23 + 8 (Q4_0) or 2^23 + 128 (Q8_0's
    biased byte): the level, exactly."""
    n = np.arange(256, dtype=np.uint32)
    f = (np.uint32(0x4B000000) | n).view(np.float32)
    q4 = (f[:16] - np.float32(8388616.0)).astype(np.float32)
    assert np.array_equal(q4, np.arange(16, dtype=np.float32) - 8)
    signed = np.arange(-128, 128, dtype=np.int32)
    biased = ((signed.astype(np.uint32) & 0xFF) ^ 0x80).astype(np.uint32)
    q8 = ((np.uint32(0x4B000000) | biased).view(np.float32) - np.float32(8388736.0))
    assert np.array_equal(q8, signed.astype(np.float32))


def test_q4_int8_fold_is_the_same_integer():
    """sum (n - 8) x = sum n x - 8 sum x over a 32-block, n the unsigned nibble."""
    rng = np.random.default_rng(3)
    for _ in range(200):
        nib = rng.integers(0, 16, 32)
        x = rng.integers(-127, 128, 32)
        assert int(((nib - 8) * x).sum()) == int((nib * x).sum()) - 8 * int(x.sum())


# ---- K6b's plan (csrc/ffn_planar.cu) ----------------------------------------------

PLANAR_SHAPES = [(TINY["d"], TINY["f"]), (L7B["d"], L7B["f"]), (512, 320), (576, 1536),
                 (64, 96)]


def _planar_stages(plan: dp.PlanarPlan, b: int):
    """(phase, tile, first block, blocks) of block b's stages in the order
    the producer copies them and the consumers take them."""
    for p in range(2):
        t0, t1 = dp.planar_tile_range(plan.tiles[p], plan.grid, b)
        for c0, nb, _ in dp.planar_chunks(plan.nblk[p], plan.kc, plan.ks):
            for t in range(t0, t1):
                for s0 in range(c0, c0 + nb, plan.ks):
                    yield p, t, s0, min(plan.ks, c0 + nb - s0)


@pytest.mark.parametrize("m", (1, 4, 7, 8, 9, 16, 17, 32))
@pytest.mark.parametrize("d,f", PLANAR_SHAPES)
def test_planar_plan_fits_and_covers_every_block_once(d, f, m):
    """K6b: the ring, the staged x chunk, the warps' sums and the per-tile
    sums fit one block's shared memory; each weight row's quant blocks are
    copied exactly once over the grid; every copy is 16-byte aligned and
    fits its slot; the x chunk splits in place (M * kc <= 512)."""
    plan = dp.planar_plan(m, d, f, SMS)
    assert plan.grid == SMS and 2 <= plan.stages <= dp.MAX_STAGES
    assert plan.smem_bytes == (dp.HEADER_BYTES + plan.stages * plan.slot_bytes + plan.x_bytes
                               + plan.part_bytes + plan.acc_bytes) <= 232_448
    assert plan.kc % plan.ks == 0 and plan.ks % 16 == 0 and m * plan.kc <= 512
    assert plan.x_bytes == m * (plan.kc * 64 + dp.PLANAR_XPAD) * 4
    assert plan.part_bytes == 16 * dp.PLANAR_TILE * 8 * 4
    chunked = max(plan.nblk) > plan.kc
    assert plan.acc_bytes == (plan.max_tiles * dp.PLANAR_TILE * m * 4 if chunked else 0)
    rows = (2 * f, d)
    seen = [np.zeros((rows[p], plan.nblk[p]), np.int64) for p in range(2)]
    qs_area = dp.PLANAR_TILE * (plan.ks * 16 + dp.PLANAR_ROW_PAD)
    for b in range(plan.grid):
        for p, t, s0, nb in _planar_stages(plan, b):
            nblk = plan.nblk[p]
            per = dp.PLANAR_TILE // (2 if p == 0 else 1)
            off = f if p == 0 else 0
            tile_rows = [t * per + r % per + (r // per) * off for r in range(dp.PLANAR_TILE)]
            whole = nblk % 8 != 0
            sc_bytes = dp.PLANAR_TILE * (nblk if whole else nb) * 2
            assert qs_area + sc_bytes <= plan.slot_bytes
            for row in tile_rows:
                seen[p][row, s0:s0 + nb] += 1
                assert (row * nblk * 16 + s0 * 16) % 16 == 0 and nb * 16 % 16 == 0
                if not whole:
                    assert ((row * nblk + s0) * 2) % 16 == 0 and (nb * 2) % 16 == 0
            if whole:                           # a segment's rows' scales in one copy
                for seg in range(2 if p == 0 else 1):
                    r0 = tile_rows[seg * per]
                    assert (r0 * nblk * 2) % 16 == 0 and (per * nblk * 2) % 16 == 0
    assert all((s == 1).all() for s in seen), "a weight block is copied twice or never"


def test_planar_plan_at_the_main_shapes_keeps_a_deep_ring():
    """kv8_tiny's batch-4 decode (M 4) and the 7-token prompt (M 7) at
    TinyLlama-1.1B and Llama-2-7B: at least 4 slots, h's first chunk whole
    in shared memory (one chunk of gate|up), down in at most 3 chunks at
    TinyLlama-1.1B."""
    for m in (4, 7):
        for s in (TINY, L7B):
            plan = dp.planar_plan(m, s["d"], s["f"], SMS)
            assert plan.stages >= dp.PLANAR_MIN_STAGES
            chunks = [len(dp.planar_chunks(nb, plan.kc, plan.ks)) for nb in plan.nblk]
            if s is TINY:
                assert chunks[0] == 1 and chunks[1] <= 3
    plan = dp.planar_plan(1, L7B["d"], L7B["f"], SMS)
    assert max(plan.nblk) <= plan.kc                 # one row: x whole at 7B


# ---- K4's split rule (csrc/decode_attn.cu) -------------------------------------------

@pytest.mark.parametrize("hd", (64, 128))
@pytest.mark.parametrize("b,hkv", [(1, 4), (4, 4), (1, 32), (2, 2), (3, 8)])
@pytest.mark.parametrize("s", (64, 256, 2048))
def test_decode_splits_cover_every_key_once(b, hkv, s, hd):
    """Every key j < kv_len of a row is taken by exactly one split, the
    splits in key order and in whole 32-key groups but the last; the grid
    is one wave of the H100's SMs at most (two blocks an SM at head_dim <=
    64, one above); and the live splits (the merge's count) are
    min(n_split, groups)."""
    n = dp.decode_splits(b, hkv, s, hd, SMS)
    per_sm = 2 if hd <= 64 else 1
    assert 1 <= n <= dp.DECODE_MAX_SPLIT and b * hkv * n <= max(per_sm * SMS, b * hkv)
    for kv_len in sorted({0, 1, 31, 32, 33, 127, 128, 129, 200, s - 1, s, s + 5}):
        keys = [dp.decode_split_keys(kv_len, s, n, sp) for sp in range(n)]
        covered = [j for k0, k1 in keys for j in range(k0, k1)]
        assert covered == list(range(min(kv_len, s)))
        assert all(k0 % dp.DECODE_GROUP == 0 for k0, k1 in keys if k1 > k0)
        groups = -(-min(kv_len, s) // dp.DECODE_GROUP)
        assert sum(k1 > k0 for k0, k1 in keys) == min(n, groups)


def test_decode_splits_at_the_main_shapes():
    """TinyLlama-1.1B batch 1 (4 KV heads of 64) and batch 4, Llama-2-7B
    batch 1 (32 KV heads of 128), S 2048: 16, 16 and 4 splits."""
    assert dp.decode_splits(1, 4, 2048, 64, SMS) == 16
    assert dp.decode_splits(4, 4, 2048, 64, SMS) == 16
    assert dp.decode_splits(1, 32, 2048, 128, SMS) == 4
