"""The whole-stack megacalls' launch plan (K14 / K15, ops/decode_plan.py
stack_plan) and the arithmetic of K15's bf16 dot, on the CPU: torch and numpy
only, no card.

The plan is checked as csrc/stack_decode.cu reads it: a layer's four weights
(wqkv in RoPE-pair runs of one head, wo, w_gate_up in (gate row, up row)
runs, w_down) each copied exactly once a layer, every bulk copy 16-byte
aligned, the ring and the activation area inside one block's shared memory,
`ahead` at least one stage, less than the ring and at most
STACK_AHEAD_BYTES' worth (or one slot), and shapes it cannot fit refused with
NotImplementedError. The producer's gate (weight_stream.cuh Gate) is
emulated over a layer's stage counts, and its per-block counts (stage_count,
a group at a time) are held to the stages each block copies in the
megacalls', K7's and K6's plans.

K15's dot (weight_stream.cuh dot_bf16) is emulated bit for bit: the bf16x2
levels of a Q4_0 word (0x4300 | nibble, less 136) times the bf16 scale give
tapekernel.bf16_weight's weights exactly, and the block and lane order of
its f32 sums (fma from 0 in pair order within a block, the blocks of a lane
added, the xor butterfly over the lanes) is held to float64 within 2x the
rms error of the plain version, tapekernel.bf16_matmul.

The float64 yardstick of the card's rms checks (stackkernel.stacked_decode_f64)
is held to the plain versions of K14 and K15 on a small stack.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from zgml_tpu_torch.ops import decode_plan as dp
from zgml_tpu_torch.ops import refs
from zgml_tpu_torch.ops.stackkernel import StackedLayers, stacked_decode_f64, stacked_decode_ref
from zgml_tpu_torch.ops.tapekernel import Tape, bf16_matmul, bf16_weight, tape_decode_ref
from zgml_tpu_torch.quant.packed import QS_BLOCK_BYTES, PackedWeight, from_nibbles
from zgml_tpu_torch.utils.synthetic import TINY_TEST

SMS = 132
S = 2048
# (L, d, hq, hkv, hd, f): TINY_TEST, TinyLlama-1.1B, Llama-2-7B, the port's
# CPU test width (d 512) and every compiled head dim at n_rep 1, 4 and 8
STACK_SHAPES = ([(TINY_TEST.n_layers, TINY_TEST.d_model, TINY_TEST.n_heads,
                  TINY_TEST.n_kv_heads, TINY_TEST.d_model // TINY_TEST.n_heads, TINY_TEST.d_ff),
                 (22, 2048, 32, 4, 64, 5632), (32, 4096, 32, 32, 128, 11008),
                 (3, 512, 8, 2, 64, 768)]
                + [(2, 8 * hd, 8, 8 // n_rep, hd, 1024) for hd in range(32, 257, 32)
                   for n_rep in (1, 4, 8)])


def _copies(ph: dp.Phase, u0: int, u1: int):
    for u, c in dp.stages_of(ph, u0, u1):
        row, n = dp.unit_row(ph, u), c * ph.unit_rows
        for s in range(ph.segs):
            yield s, row + s * ph.seg_off, n


def _check_phase(ph: dp.Phase, n_rows: int, plan: dp.StreamPlan):
    rq, rd = ph.k // 32 * QS_BLOCK_BYTES["q4_0"], ph.k // 16
    seen = np.zeros(n_rows, np.int64)
    for b in range(plan.grid):
        for u, c in dp.stages_of(ph, ph.bounds[b], ph.bounds[b + 1]):
            rows = c * ph.unit_rows
            assert ph.segs * rows * (rq + rd) <= plan.slot_bytes
            assert ph.segs * rows % dp.ITEM_ROWS == 0
            assert (rows * rq) % 16 == 0 and (rows * rd) % 16 == 0
        for _, row, n in _copies(ph, ph.bounds[b], ph.bounds[b + 1]):
            assert (row * rq) % 16 == 0 and (n * rq) % 16 == 0
            assert (row * rd) % 16 == 0 and (n * rd) % 16 == 0
            seen[row:row + n] += 1
    assert (seen == 1).all(), "a weight row is copied twice or never in a layer"
    assert ph.bounds[0] == 0 and ph.bounds[-1] == ph.units


@pytest.mark.parametrize("n_layers,d,hq,hkv,hd,f", STACK_SHAPES)
def test_stack_plan(n_layers, d, hq, hkv, hd, f):
    plan = dp.stack_plan(n_layers, d, hq, hkv, hd, f, S, SMS)
    assert plan.grid == SMS and plan.mr == 1 and len(plan.phases) == 4
    assert 2 <= plan.stages <= dp.MAX_STAGES and plan.slot_bytes % dp.SLOT_ALIGN == 0
    assert plan.smem_bytes == dp.HEADER_BYTES + plan.stages * plan.slot_bytes + plan.act_bytes
    assert plan.smem_bytes <= dp.SMEM_LIMIT
    assert plan.act_bytes == dp.stack_act_bytes(n_layers, d, hq, hkv, hd, f, S, SMS)
    assert plan.ahead == max(1, min(plan.stages - 1, dp.STACK_AHEAD_BYTES // plan.slot_bytes))
    assert 1 <= plan.ahead < plan.stages
    assert plan.ahead * plan.slot_bytes <= max(dp.STACK_AHEAD_BYTES, plan.slot_bytes)
    pa, pc, pgu, pdn = plan.phases
    _check_phase(pa, (hq + 2 * hkv) * hd, plan)
    _check_phase(pc, d, plan)
    _check_phase(pgu, 2 * f, plan)
    _check_phase(pdn, d, plan)
    assert (pa.segs, pa.seg_off, pa.group_rows, pa.group_units * pa.unit_rows) == (
        2, hd // 2, hd, hd // 2)
    assert (pc.k, pgu.k, pdn.k) == (hq * hd, d, f)
    assert (pc.segs, pgu.segs, pgu.seg_off, pdn.segs) == (1, 2, f, 1)
    for b in range(plan.grid):            # a stage of A holds whole pairs of one head
        for s, row, n in _copies(pa, pa.bounds[b], pa.bounds[b + 1]):
            assert (row - s * (hd // 2)) % hd + n <= hd // 2
    ints = dp.host_ints(plan)
    assert len(ints) == dp.PLAN_HEADER + 4 * dp.PHASE_INTS and ints[6] == 4
    assert ints[7] == plan.ahead


@pytest.mark.parametrize("n_layers,d,hq,hkv,hd,f", [
    (2, 2048, 32, 4, 64, 65536),          # down's staged row alone overflows a block
    (2, 16384, 128, 8, 128, 53248),       # nor at 16384 / 53248
    (80, 8192, 64, 8, 128, 49152)])       # nor with the table in global memory
def test_stack_plan_refuses_what_it_cannot_fit(n_layers, d, hq, hkv, hd, f):
    with pytest.raises(NotImplementedError, match="stack_decode"):
        dp.stack_plan(n_layers, d, hq, hkv, hd, f, S, SMS)


# (L, d, hq, hkv, hd, f): the 70B shape, where the staged table leaves one
# stage, and 2000 layers of the 7B width, where the table alone fills a block
GLOBAL_TABLE_SHAPES = [(80, 8192, 64, 8, 128, 28672), (2000, 4096, 32, 32, 128, 11008)]


@pytest.mark.parametrize("s", (2048, 4096, 8192))
@pytest.mark.parametrize("n_layers,d,hq,hkv,hd,f", GLOBAL_TABLE_SHAPES)
def test_stack_plan_reads_the_table_from_global_memory_where_it_does_not_fit(
        n_layers, d, hq, hkv, hd, f, s):
    """Where the staged pointer table leaves fewer than two stages, the plan
    leaves it in global memory (act_bytes without it, which is how the kernel
    tells the two apart) and streams the layers as every other plan does."""
    staged = dp.stack_act_bytes(n_layers, d, hq, hkv, hd, f, s, SMS)
    plan = dp.stack_plan(n_layers, d, hq, hkv, hd, f, s, SMS)
    assert (dp.SMEM_LIMIT - dp.HEADER_BYTES - staged) // plan.slot_bytes < 2
    assert plan.act_bytes == dp.stack_act_bytes(n_layers, d, hq, hkv, hd, f, s, SMS, table=False)
    assert plan.act_bytes < staged
    assert 2 <= plan.stages and plan.smem_bytes <= dp.SMEM_LIMIT
    assert plan.smem_bytes == dp.HEADER_BYTES + plan.stages * plan.slot_bytes + plan.act_bytes
    assert 1 <= plan.ahead < plan.stages
    pa, pc, pgu, pdn = plan.phases
    _check_phase(pa, (hq + 2 * hkv) * hd, plan)
    _check_phase(pc, d, plan)
    _check_phase(pgu, 2 * f, plan)
    _check_phase(pdn, d, plan)


@pytest.mark.parametrize("n_layers,d,hq,hkv,hd,f", STACK_SHAPES)
def test_stack_plan_keeps_the_staged_table_where_it_fits(n_layers, d, hq, hkv, hd, f):
    """Every shape that planned with the table in shared memory keeps that
    plan: the same act_bytes (so the kernel stages the table), ring and
    phases at S 2048 and at 131072."""
    for s in (S, 131072):
        plan = dp.stack_plan(n_layers, d, hq, hkv, hd, f, s, SMS)
        act = dp.stack_act_bytes(n_layers, d, hq, hkv, hd, f, s, SMS, table=True)
        assert plan.act_bytes == act and plan.stages >= 2


def _stream(plan: dp.StreamPlan, b: int, n_layers: int):
    """(phase index, stage) of block b's stream, in the producer's order."""
    out = []
    for l in range(n_layers):
        for k, ph in enumerate(plan.phases):
            out += [(4 * l + k, st) for st in dp.stages_of(ph, ph.bounds[b], ph.bounds[b + 1])]
    return out


@pytest.mark.parametrize("ahead", (1, 2))
def test_gate_holds_ahead_stages_past_the_staged_phase(ahead):
    """The gate's end(j) is the stream index after phase j's stages, so with g
    phases staged at most `ahead` stages of later phases may be copied."""
    n_layers = 3
    plan = dp.stack_plan(n_layers, 512, 8, 2, 64, 768, S, 16)
    for b in range(plan.grid):
        cnt = [len(dp.stages_of(ph, ph.bounds[b], ph.bounds[b + 1])) for ph in plan.phases]
        stream = _stream(plan, b, n_layers)

        def end(j):                      # weight_stream.cuh Gate::end
            k = j % 4
            return (j // 4) * sum(cnt) + sum(cnt[:k + 1])
        for g in range(1, 4 * n_layers + 1):
            limit = end(g - 1) + ahead
            assert all(j < g for j, _ in stream[:end(g - 1)])
            assert all(j >= g for j, _ in stream[end(g - 1):limit])
            assert len(stream[end(g - 1):limit]) <= ahead


def _stage_count(ph: dp.Phase, u0: int, u1: int) -> int:
    """weight_stream.cuh stage_count: the stages of [u0, u1), a group at a time."""
    c, u = 0, u0
    while u < u1:
        end = min(u1, (u // ph.group_units + 1) * ph.group_units)
        c += -(-(end - u) // ph.unit_max)
        u = end
    return c


@pytest.mark.parametrize("plan_of,args", [
    (dp.stack_plan, (22, 2048, 32, 4, 64, 5632, S)),
    (dp.stack_plan, (32, 4096, 32, 32, 128, 11008, S)),
    (dp.stack_plan, (3, 512, 8, 2, 64, 768, S)),
    (dp.attn_plan, (2048, 32, 4, 64, "q4_0", False, False, S)),
    (dp.attn_plan, (4096, 32, 32, 128, "q8_0", True, True, S)),
    (dp.ffn_plan, (1, 2048, 5632, "q8_0", False)),
    (dp.ffn_plan, (8, 4096, 11008, "q4_0", True))])
@pytest.mark.parametrize("sms", (SMS, 114, 16))
def test_gate_stage_counts_are_the_stages_a_block_copies(plan_of, args, sms):
    """The gate's per-block stage counts (weight_stream.cuh stage_count, a
    group at a time) equal the stages the producer copies (stage_units' cut)."""
    plan = plan_of(*args, sms)
    for ph in plan.phases:
        for b in range(plan.grid):
            u0, u1 = ph.bounds[b], ph.bounds[b + 1]
            assert _stage_count(ph, u0, u1) == len(dp.stages_of(ph, u0, u1))


# ---- K15's dot ---------------------------------------------------------------------

def _bf16_bits(v: np.ndarray) -> np.ndarray:
    """Round float32 values to bf16 (nearest, ties to even) -> uint16 bits."""
    u = v.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def _bits_f32(b: np.ndarray) -> np.ndarray:
    return (b.astype(np.uint32) << 16).view(np.float32)


# the elements of a pair at shift 4 s of word q (dot_bf16's pair order)
def _pair_elems(q: int, s: int) -> tuple[int, int]:
    k, h = s // 2, s % 2
    return 16 * h + 4 * q + k, 16 * h + 4 * q + k + 2


def _kernel_weights(qs: np.ndarray, d: np.ndarray) -> np.ndarray:
    """dot_bf16's weights as bf16 bits [n, k] in natural element order: per
    word q of a block, pairs lv = ((w >> 4 s) & 0x000F000F) | 0x43004300, less
    136 in bf16 (exact), times bf16_rn(d) with one rounding."""
    n, nb = d.shape
    words = qs.reshape(n, nb, 4, 4).view(np.uint32)[..., 0]     # [n, nb, 4] little-endian
    sc = _bits_f32(_bf16_bits(d.astype(np.float32)))            # bf16_rn(d)
    out = np.zeros((n, nb, 32), np.uint16)
    for q in range(4):
        for s in range(4):
            lv = ((words[..., q] >> np.uint32(4 * s)) & np.uint32(0x000F000F)) | np.uint32(
                0x43004300)
            for half, e in zip((lv & 0xFFFF, lv >> 16), _pair_elems(q, s)):
                level = _bits_f32(half.astype(np.uint16)) - np.float32(136)
                assert np.all(np.abs(level) <= 8)               # exact: an integer
                prod = level.astype(np.float64) * sc.astype(np.float64)
                assert np.all(prod.astype(np.float32) == prod)  # exact in f32
                out[..., e] = _bf16_bits(prod.astype(np.float32))
    return out.reshape(n, nb * 32)


def _random_q4(rng, n, k):
    nib = rng.integers(0, 16, (n, k), dtype=np.uint8)
    d = (rng.random((n, k // 32)) * 0.02 + 0.001).astype(np.float16)
    return from_nibbles(nib, d, device="cpu")


def test_bf16_pair_weights_are_bf16_weight_bit_for_bit():
    rng = np.random.default_rng(15)
    w = _random_q4(rng, 48, 512)
    got = _kernel_weights(w.qs.numpy(), w.d.numpy())
    want = bf16_weight(w).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    assert np.array_equal(got, want)


def test_bf16_pairs_cover_every_element_once():
    elems = sorted(e for q in range(4) for s in range(4) for e in _pair_elems(q, s))
    assert elems == list(range(32))


def _fma32(a, b, c):
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def _kernel_dot(wrow: np.ndarray, x: np.ndarray) -> np.float32:
    """One row as dot_bf16 sums it (wrow, x: bf16-valued float32 [k])."""
    nb = wrow.size // 32
    acc = np.zeros(32, np.float32)
    order = [e for q in range(4) for s in range(4) for e in _pair_elems(q, s)]
    for b in range(nb):
        s = np.float32(0)
        for e in order:
            s = _fma32(wrow[32 * b + e], x[32 * b + e], s)
        acc[b % 32] = np.float32(acc[b % 32] + s)
    off = 16
    while off:
        acc = (acc + acc[np.arange(32) ^ off]).astype(np.float32)
        off //= 2
    return acc[0]


@pytest.mark.parametrize("k", (2048, 5632))
def test_bf16_dot_order_against_float64(k):
    rng = np.random.default_rng(k)
    w = _random_q4(rng, 12, k)
    wf = bf16_weight(w).numpy()
    xs = rng.standard_normal((6, k)).astype(np.float32)
    xb = torch.from_numpy(xs).to(torch.bfloat16).to(torch.float32).numpy()
    plain = bf16_matmul(torch.from_numpy(xs), w).numpy()              # [6, 12]
    exact = xb.astype(np.float64) @ wf.astype(np.float64).T
    kern = np.array([[_kernel_dot(wf[r], xb[m]) for r in range(w.n)] for m in range(6)])
    rms_kernel = float(np.sqrt(np.mean((kern - exact) ** 2)))
    rms_plain = float(np.sqrt(np.mean((plain - exact) ** 2)))
    assert rms_kernel <= 2.0 * rms_plain + 1e-12


@pytest.mark.parametrize("bf16", (False, True))
def test_float64_reference_agrees_with_the_plain_versions(bf16):
    """stacked_decode_f64 on the exact weights is K14's plain version in
    float64 (max abs difference 1e-5 x max|out|); on bf16_weight's it is
    K15's without the operand roundings (rms difference within 1e-2 of the
    outputs' rms), every layer's k_cur / v_cur and the final x."""
    rng = np.random.default_rng(21 + bf16)
    n_layers, hq, hkv, hd, f, s, pos = 2, 4, 2, 32, 256, 16, 5
    d = hq * hd

    def norm():
        return torch.from_numpy((1 + 0.1 * rng.standard_normal(d)).astype(np.float32))
    layers = [{"attn_norm": norm(), "ffn_norm": norm(),
               "wqkv": _random_q4(rng, (hq + 2 * hkv) * hd, d), "wo": _random_q4(rng, d, d),
               "w_gate_up": _random_q4(rng, 2 * f, d), "w_down": _random_q4(rng, d, f)}
              for _ in range(n_layers)]
    stack = StackedLayers(layers, hq, hkv, 1e-5)
    x = torch.from_numpy(rng.standard_normal((1, 1, d)).astype(np.float32))
    ck, cv = (torch.from_numpy(rng.standard_normal((n_layers, 1, hkv, s, hd)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    cos, sin = refs.rope_cos_sin(torch.tensor([pos]), hd)
    if bf16:
        want = tape_decode_ref(x, Tape(stack, ()), ck.clone(), cv.clone(), pos, cos, sin)
    else:
        want = stacked_decode_ref(x, stack, ck.clone(), cv.clone(), pos, cos, sin)
    exact = stacked_decode_f64(x, stack, ck, cv, pos, cos, sin,
                               bf16_weight if bf16 else PackedWeight.dequant)
    flat = torch.cat([t.reshape(-1) for t in want]).double()
    assert flat.shape == exact.shape
    if bf16:
        assert float((flat - exact).square().mean().sqrt()) <= 1e-2 * float(
            exact.square().mean().sqrt())
    else:
        assert float((flat - exact).abs().max()) <= 1e-5 * float(exact.abs().max())


# (L, d, hq, hkv, hd, f, S): TinyLlama-1.1B's 22 layers, Llama-2-7B's 32, and
# the 70B width's 80 (chip_smoke.WIDE_STACK's cache), where the table is read
# from global memory
F32_CACHE_SHAPES = [(22, 2048, 32, 4, 64, 5632, 2048), (32, 4096, 32, 32, 128, 11008, 2048),
                    (80, 8192, 64, 8, 128, 28672, 1500)]


@pytest.mark.parametrize("n_layers,d,hq,hkv,hd,f,s", F32_CACHE_SHAPES)
def test_stack_plan_over_the_f32_cache_is_the_bf16_plan(n_layers, d, hq, hkv, hd, f, s):
    """Phase B's f32 chunk stages K, then V, in the bf16 chunk's area
    (csrc/decode_split.cuh), so one plan serves both caches: stack_plan and
    the kernel's stack_act_bytes size phase B by the bf16 chunk, which is
    the f32 chunk's byte for byte. The plan fits at each shape, the 70B
    width with the table read from global memory."""
    n_rep = hq // hkv
    assert (dp.decode_chunk_smem_bytes(hd, dp.KV_F32, n_rep)
            == dp.decode_chunk_smem_bytes(hd, dp.KV_BF16, n_rep))
    plan = dp.stack_plan(n_layers, d, hq, hkv, hd, f, s, SMS)
    staged = dp.stack_act_bytes(n_layers, d, hq, hkv, hd, f, s, SMS)
    assert plan.stages >= 2 and plan.act_bytes in (
        staged, dp.stack_act_bytes(n_layers, d, hq, hkv, hd, f, s, SMS, table=False))
    assert (plan.act_bytes == staged) == (n_layers < 80)
