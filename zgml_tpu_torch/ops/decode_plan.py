"""Launch plans of the weight-streaming decode kernels: K7 (csrc/layer_attn.cu),
K6d / K6a / K6c (csrc/ffn.cu), the megacalls K14 / K15 (csrc/stack_decode.cu)
and K6b (csrc/ffn_planar.cu, `planar_plan`), all built on
csrc/weight_stream.cuh; and K4's and K8's split of a row's keys
(csrc/decode_attn.cu, `decode_splits`, `decode_split_keys`).

Each kernel runs one persistent block an SM: 16 consumer warps and one
producer warp, which streams the block's weight rows with 1D bulk copies
(TMA) through a ring of `stages` slots of `slot_bytes` in shared memory,
beside an area of `act_bytes` for the staged activations (and K7's phase B).
A phase (K7: A over wqkv, C over wo, and with its phase E gate|up and down
as K6d's; K6: gate|up, then down) is a list of
units, each a few weight rows of one or two segments (K7 A: the two rows of
a RoPE pair; K6 gate|up: a gate row and its up row), split into contiguous,
balanced ranges, one per block. A block cuts its range into stages of at
most `unit_max` units, never across a group (K7 A: a head), so a stage is
`segs` runs of contiguous rows; the producer copies each run's qs and fp16
scale rows, the consumers dot each pair of rows (one warp an item). Every
copy starts and ends on a multiple of 16 bytes: a unit is `unit_rows` rows,
enough that unit_rows * K/16 bytes of scales are a multiple of 16.

The plan is a pure function of the shapes, the kind, the SM count and the
stage target, and the kernel reads it as given (no occupancy query at
launch): `launch_args` caches it per shape and card as the host ints and
the device table of range bounds that the launchers take (K6b: `planar_args`,
host ints only; a block computes its tiles as K4 its keys).
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import NamedTuple

import torch

from zgml_tpu_torch.quant.packed import QS_BLOCK_BYTES

SMEM_LIMIT = 232_448       # dynamic shared memory one block of the H100 may use
MAX_STAGES = 16            # ws::MAX_STAGES: mbarrier pairs in the header
HEADER_BYTES = 384         # ws::HEADER_BYTES: 2 * MAX_STAGES + 1 mbarriers, the gate's count,
                          # the megacalls' unit ranges, 16 reduction floats
STAGE_BYTES = 32 * 1024    # default slot size (a larger unit takes a larger slot)
SLOT_ALIGN = 128
XPAD = 36                  # floats per staged f32 32-block (ws::XPAD): conflict-free float4s
XQ_BYTES = 56              # bytes per staged int8 32-block: 48 of levels, a scale, a sum
DA_CHUNK = 128             # csrc/decode_split.cuh: keys per phase-B chunk
PLAN_HEADER = 8            # ints before the phases in the host array
AHEAD_BYTES = 32 * 1024    # bytes copied past the last phase whose activations are staged
PHASE_INTS = 6             # segs, seg_off, unit_rows, group_units, group_rows, unit_max


class Phase(NamedTuple):
    """One streamed weight: rows of length k, in units of `unit_rows` rows per
    segment. Unit u's first row is (u // group_units) * group_rows +
    (u % group_units) * unit_rows; with segs 2 the same rows + seg_off are
    its second segment. Block b takes units [bounds[b], bounds[b + 1])."""
    k: int
    segs: int
    seg_off: int
    unit_rows: int
    group_units: int
    group_rows: int
    unit_max: int
    units: int
    bounds: tuple[int, ...]


class StreamPlan(NamedTuple):
    grid: int
    stages: int
    slot_bytes: int
    act_bytes: int
    smem_bytes: int
    mr: int                     # K6's rows per group (1 for K7)
    ahead: int                  # stages copied past the last phase whose rows are staged
    phases: tuple[Phase, ...]   # K7: (A, C); K6: (gate|up, down)


def row_bytes(k: int, kind: str) -> int:
    """Bytes of one weight row: its qs blocks and its fp16 scales."""
    return k // 32 * QS_BLOCK_BYTES[kind] + k // 16


def align_rows(k: int) -> int:
    """The fewest rows whose fp16 scales (k/16 bytes a row) fill a multiple
    of 16 bytes; qs rows (k/2 or k bytes, k % 32 == 0) always do."""
    return 16 // math.gcd(k // 16, 16)


ITEM_ROWS = 2              # weight rows a warp dots at once (ws::ITEM_ROWS)


def _phase(k, kind, segs, seg_off, unit_rows, group_units, group_rows, units, grid, slot):
    unit_max = max(1, slot // (segs * unit_rows * row_bytes(k, kind)))
    bounds = tuple(b * units // grid for b in range(grid + 1))
    return Phase(k, segs, seg_off, unit_rows, group_units, group_rows, unit_max, units, bounds)


def stages_of(ph: Phase, u0: int, u1: int) -> list[tuple[int, int]]:
    """(first unit, units) of each stage of the range [u0, u1), as the kernel
    cuts it (csrc/weight_stream.cuh stage_units)."""
    out, u = [], u0
    while u < u1:
        c = min(u1 - u, ph.unit_max, ph.group_units - u % ph.group_units)
        out.append((u, c))
        u += c
    return out


def unit_row(ph: Phase, u: int) -> int:
    return (u // ph.group_units) * ph.group_rows + (u % ph.group_units) * ph.unit_rows


def _ring(phases_of, act_bytes: int, slot: int, rounds: int = 1) -> int:
    """Slots: as many as fit beside the activations, at most MAX_STAGES and
    at most the stages the busiest block runs (`rounds` times over)."""
    phases = phases_of(slot)
    grid = len(phases[0].bounds) - 1
    need = max(sum(len(stages_of(ph, ph.bounds[b], ph.bounds[b + 1])) for ph in phases)
               for b in range(grid)) * rounds
    fit = (SMEM_LIMIT - HEADER_BYTES - act_bytes) // slot
    return min(MAX_STAGES, fit, max(1, need))


def _slot(units_bytes: list[int], stage_bytes: int) -> int:
    """The slot: the largest stage a phase fills with whole units up to
    stage_bytes (one unit where a unit is larger)."""
    most = max(max(1, stage_bytes // u) * u for u in units_bytes)
    return -(-most // SLOT_ALIGN) * SLOT_ALIGN


def _ahead(slot: int) -> int:
    """Stages the producer copies past the last phase whose activations the
    consumers staged (ws::Gate): AHEAD_BYTES' worth, at least one."""
    return max(1, AHEAD_BYTES // slot)


KV_BF16, KV_INT8, KV_F32 = 0, 1, 2   # K7's cache forms (the `kv` argument; False / True
                                    # stand for the first two)


def decode_chunk_smem_bytes(hd: int, kv: int, n_rep: int) -> int:
    """csrc/decode_split.cuh decode_chunk_smem_bytes<hd, kv == KV_INT8>(n_rep):
    the f32 cache's chunk stages K, then V in the same buffer, and takes the
    bf16 cache's area."""
    if kv == KV_INT8:
        return 4 * (n_rep * hd // 4 + n_rep + n_rep * DA_CHUNK + DA_CHUNK * (hd // 4 + 1)
                    + DA_CHUNK * (hd // 4) + 2 * DA_CHUNK)
    return 4 * (n_rep * hd + n_rep * DA_CHUNK) + 4 * (DA_CHUNK * (hd // 2 + 1)
                                                      + DA_CHUNK * (hd // 2))


def xq_row_bytes(d: int) -> int:
    """Bytes of one staged int8 row of d values (levels, scales, sums),
    rounded up to 16 (csrc/weight_stream.cuh xq_words)."""
    return -(-(d // 32 * XQ_BYTES) // 16) * 16


def attn_act_bytes(d: int, hq: int, hkv: int, hd: int, a_i8: bool, kv: int, s: int,
                   grid: int, f: int = 0) -> int:
    """K7's activation area: phase A's normed x (f32, or int8 with its scales
    and sums) with x and g as copied behind it; phase B's chunk and an int
    for each item (KV head, 128-key chunk of an S-row cache) a block of the
    grid takes; phase C's staged attention; with phase E (f > 0) x2 as a raw
    row of d floats and the staged normed x2 or SwiGLU row behind it
    (csrc/layer_attn.cu attn_act_bytes)."""
    a = (xq_row_bytes(d) if a_i8 else d // 32 * XPAD * 4) + 2 * d * 4
    items = hkv * -(-s // DA_CHUNK)         # phase B's (KV head, chunk) items
    b = decode_chunk_smem_bytes(hd, kv, hq // hkv) + 4 * -(-items // grid)
    c = hq * hd // 32 * XPAD * 4
    e = d * 4 + max(d, f) // 32 * XPAD * 4 if f else 0
    return max(a, b, c, e)


def ffn_act_bytes(d: int, f: int, mr: int, a_i8: bool) -> int:
    """K6's activation area: mr normed rows for gate|up (f32, or K6c's int8)
    with the first group's x rows and g as copied behind them, then mr
    SwiGLU rows for down (csrc/ffn.cu ffn_act_bytes)."""
    gu = mr * (xq_row_bytes(d) if a_i8 else d // 32 * XPAD * 4) + (mr + 1) * d * 4
    return max(gu, mr * f // 32 * XPAD * 4)


def attn_plan(d: int, hq: int, hkv: int, hd: int, kind: str, a_i8: bool, kv: int, s: int,
              sm_count: int, stage_bytes: int | None = None, f: int = 0) -> StreamPlan:
    """K7's plan for an S-row cache of form `kv` (KV_BF16 / False, KV_INT8 /
    True, KV_F32): phase A over wqkv in units of RoPE-pair
    runs of one head (rows h*hd + i and h*hd + hd/2 + i), phase C over wo in
    runs of rows; with f > 0 (phase E, a d_ff of f) then K6d's two phases,
    gate|up in (gate row, up row) runs and down in runs of rows, through the
    same ring (attn_ffn_plan)."""
    half = hd // 2
    ga = math.lcm(align_rows(d), ITEM_ROWS // 2)   # pairs a unit (divides half % 16 == 0)
    gc = math.lcm(align_rows(hq * hd), ITEM_ROWS)  # rows a unit
    grid = max(1, sm_count)
    units_a, units_c = (hq + 2 * hkv) * half // ga, d // gc
    gd = math.lcm(align_rows(f), ITEM_ROWS) if f else 0

    def phases(slot):
        out = (_phase(d, kind, 2, half, ga, half // ga, hd, units_a, grid, slot),
               _phase(hq * hd, kind, 1, 0, gc, units_c, 0, units_c, grid, slot))
        if f:
            out += (_phase(d, kind, 2, f, ga, f // ga, 0, f // ga, grid, slot),
                    _phase(f, kind, 1, 0, gd, d // gd, 0, d // gd, grid, slot))
        return out
    act = attn_act_bytes(d, hq, hkv, hd, a_i8, kv, s, grid, f)
    units = [2 * ga * row_bytes(d, kind), gc * row_bytes(hq * hd, kind)]
    if f:
        units.append(gd * row_bytes(f, kind))
    slot = _slot(units, stage_bytes or STAGE_BYTES)
    stages = _ring(phases, act, slot)
    if stages < 1:
        raise ValueError(f"attn_block: d {d}, heads {hq}/{hkv} x {hd} at {kind} leave no room "
                         f"for a {slot}-byte stage beside {act} bytes of activations")
    return StreamPlan(grid, stages, slot, act, HEADER_BYTES + stages * slot + act, 1,
                      _ahead(slot), phases(slot))


def attn_ffn_plan(d: int, hq: int, hkv: int, hd: int, kind: str, a_i8: bool, kv: int, s: int,
                  f: int, sm_count: int, stage_bytes: int | None = None) -> StreamPlan:
    """K7 with its phase E (ZGML_TPU_LAYER_FFN): attn_plan's two phases, then
    gate|up and down of a d_ff of f, four phases through one ring."""
    return attn_plan(d, hq, hkv, hd, kind, a_i8, kv, s, sm_count, stage_bytes, f)


FFN_GROUPS = (4, 2, 1)      # rows a group (csrc/ffn.cu instantiations)


def ffn_plan(m: int, d: int, f: int, kind: str, a_i8: bool, sm_count: int,
             stage_bytes: int | None = None) -> StreamPlan:
    """K6's plan: gate|up in units of (gate row, up row) runs, down in runs
    of rows; the rows in groups of mr (the fewest groups whose staging
    leaves a ring of four slots, else of two, else of one), each group
    streaming both weights once."""
    grid = max(1, sm_count)

    gg = math.lcm(align_rows(d), ITEM_ROWS // 2)
    gd = math.lcm(align_rows(f), ITEM_ROWS)

    def phases(slot):
        return (_phase(d, kind, 2, f, gg, f // gg, 0, f // gg, grid, slot),
                _phase(f, kind, 1, 0, gd, d // gd, 0, d // gd, grid, slot))
    slot = _slot([2 * gg * row_bytes(d, kind), gd * row_bytes(f, kind)],
                 stage_bytes or STAGE_BYTES)
    fewest = min(g for g in FFN_GROUPS if g >= min(m, FFN_GROUPS[0]))
    for least in (4, 2, 1):
        for mr in (g for g in FFN_GROUPS if g <= fewest):
            act = ffn_act_bytes(d, f, mr, a_i8)
            stages = _ring(phases, act, slot, -(-m // mr))
            if stages >= least:
                return StreamPlan(grid, stages, slot, act, HEADER_BYTES + stages * slot + act,
                                  mr, _ahead(slot), phases(slot))
    raise ValueError(f"fused_ffn_norm: D {d}, F {f} at {kind} leave no room for a {slot}-byte "
                     f"stage beside one row's activations")


TABLE_SLOTS = 10          # csrc/stack_decode.cu T_SLOTS: int64 pointers a layer
STACK_AHEAD_BYTES = 64 * 1024   # the megacalls' AHEAD_BYTES (32-128 KB measured: PERF.md)


def stack_act_bytes(n_layers: int, d: int, hq: int, hkv: int, hd: int, f: int, s: int,
                    grid: int, table: bool = True) -> int:
    """The megacalls' activation area (csrc/stack_decode.cu stack_act_bytes):
    the layers' pointer table where it is staged (as copied, rounded up to
    128 bytes; `table` False: read from global memory, no area), one raw
    row of d floats (the layer's input x through phase C, then x2 through
    down), then the phases' area: A's normed x with layer 0's gain as copied
    behind it, B's chunk and an int for each of a block's items, C's staged
    attention, gate|up's normed x2, down's staged SwiGLU row."""
    table = -(-n_layers * TABLE_SLOTS * 8 // SLOT_ALIGN) * SLOT_ALIGN if table else 0
    row = d // 32 * XPAD * 4
    items = hkv * -(-s // DA_CHUNK)
    b = decode_chunk_smem_bytes(hd, KV_BF16, hq // hkv) + 4 * -(-items // grid)
    return table + d * 4 + max(row + d * 4, b, hq * hd // 32 * XPAD * 4, f // 32 * XPAD * 4)


def stack_plan(n_layers: int, d: int, hq: int, hkv: int, hd: int, f: int, s: int,
               sm_count: int) -> StreamPlan:
    """The whole-stack megacalls' plan (K14 / K15, csrc/stack_decode.cu): one
    ring through which a layer's four weights stream in order, K7's two
    phases (wqkv in RoPE-pair runs of one head, wo in runs of rows) then
    K6d's at one row (w_gate_up in (gate row, up row) runs, w_down in runs of
    rows), the same for every layer (the JAX rule: every layer has the same
    widths). `ahead` stages may be in flight past the phase whose activations
    the consumers staged last. The layers' pointer table is staged in shared
    memory beside the activations where that leaves two stages; else each
    layer's row is read from global memory (the kernel tells the two apart
    by act_bytes), which is what fits 80 layers of the 70B width. Raises
    NotImplementedError where no two slots fit beside the activations."""
    half = hd // 2
    grid = max(1, sm_count)
    ga = math.lcm(align_rows(d), ITEM_ROWS // 2)     # pairs a unit: A's and gate|up's
    gc = math.lcm(align_rows(hq * hd), ITEM_ROWS)
    gd = math.lcm(align_rows(f), ITEM_ROWS)
    units_a, units_c = (hq + 2 * hkv) * half // ga, d // gc

    def phases(slot):
        return (_phase(d, "q4_0", 2, half, ga, half // ga, hd, units_a, grid, slot),
                _phase(hq * hd, "q4_0", 1, 0, gc, units_c, 0, units_c, grid, slot),
                _phase(d, "q4_0", 2, f, ga, f // ga, 0, f // ga, grid, slot),
                _phase(f, "q4_0", 1, 0, gd, d // gd, 0, d // gd, grid, slot))
    slot = _slot([2 * ga * row_bytes(d, "q4_0"), gc * row_bytes(hq * hd, "q4_0"),
                  gd * row_bytes(f, "q4_0")], STAGE_BYTES)
    for table in (True, False):
        act = stack_act_bytes(n_layers, d, hq, hkv, hd, f, s, grid, table)
        stages = _ring(phases, act, slot, n_layers)
        if stages >= 2:
            break
    if stages < 2:
        raise NotImplementedError(
            f"stack_decode: d {d}, heads {hq}/{hkv} x {hd}, d_ff {f}, {n_layers} layers, "
            f"S {s} leave no room for two {slot}-byte stages beside {act} bytes of "
            f"activations")
    ahead = max(1, min(stages - 1, STACK_AHEAD_BYTES // slot))
    return StreamPlan(grid, stages, slot, act, HEADER_BYTES + stages * slot + act, 1, ahead,
                      phases(slot))


PLANAR_TILE = 16          # weight rows an m16n8k8 A operand (csrc/ffn_planar.cu PT_ROWS)
PLANAR_ROW_PAD = 16       # bytes after each row's qs in a slot: the 8 rows' words hit 32 banks
PLANAR_XPAD = 16          # floats after each staged x row: the B loads hit 32 banks
PLANAR_X_FLOATS = 512 * 32   # M * kc * 32 at most: the x chunk splits in place in 8 float4s a thread
PLANAR_MIN_STAGES = 4


class PlanarPlan(NamedTuple):
    """K6b's launch (csrc/ffn_planar.cu). Phase 0 (gate|up) has f/8 tiles of
    8 gate rows and the same 8 up rows, phase 1 (down) d/16 tiles of 16
    rows; block b takes tiles [b * tiles // grid, (b + 1) * tiles // grid)
    of each. The contraction goes in chunks of `kc` quant blocks (x staged
    once a chunk for all m rows, as TF32 hi / lo parts), each tile's chunk in
    stages of `ks` blocks of its 16 rows, `stages` slots of `slot_bytes`."""
    grid: int
    stages: int
    slot_bytes: int
    x_bytes: int
    part_bytes: int
    acc_bytes: int
    smem_bytes: int
    ks: int
    kc: int
    ahead: int
    max_tiles: int
    nt: int                     # n8 tiles of the m rows (1, 2 or 4): the warps' split
    tiles: tuple[int, int]      # (gate|up, down)
    nblk: tuple[int, int]       # quant blocks a row: (d / 32, f / 32)


def planar_nt(m: int) -> int:
    """n8 tiles of m rows as the kernel's 16 warps split them (1, 2 or 4):
    warp w takes tile w // (16 // nt) and the quant blocks w % (16 // nt),
    + 16 // nt, ... of each stage."""
    return 1 if m <= 8 else 2 if m <= 16 else 4


def planar_tile_range(tiles: int, grid: int, b: int) -> tuple[int, int]:
    return b * tiles // grid, (b + 1) * tiles // grid


def planar_slot_bytes(ks: int, nblk: tuple[int, int]) -> int:
    """A slot: 16 rows of ks blocks' qs (each row padded by PLANAR_ROW_PAD),
    then the scales: 16 rows of ks, or, where a row's blocks are not a
    multiple of 8 (its scale rows are then not 16-byte aligned), the tile's
    whole scale rows."""
    qs = PLANAR_TILE * (ks * 16 + PLANAR_ROW_PAD)
    sc = max(PLANAR_TILE * (nb if nb % 8 else ks) * 2 for nb in nblk)
    return -(-(qs + sc) // SLOT_ALIGN) * SLOT_ALIGN


def planar_chunks(nblk: int, kc: int, ks: int) -> list[tuple[int, int, int]]:
    """(first block, blocks, stages) of each chunk of a row of nblk blocks."""
    return [(c0, min(kc, nblk - c0), -(-min(kc, nblk - c0) // ks)) for c0 in range(0, nblk, kc)]


def planar_plan(m: int, d: int, f: int, sm_count: int) -> PlanarPlan:
    """K6b's tensor-core plan for m rows (1..32; ops/ffn.py runs it above
    PLANAR_F32_MAX_M) at d, f (multiples of 32): the widest x chunk (kc
    quant blocks, up to PLANAR_X_FLOATS / (32 m)) that leaves a ring of
    PLANAR_MIN_STAGES slots beside it, stages of 64 blocks (32 or 16 where a
    chunk holds fewer: a stage is 32 row pieces, and fewer, larger ones
    stream faster)."""
    if not (0 < m <= 32 and d > 0 and f > 0 and d % 32 == 0 and f % 32 == 0):
        raise ValueError(f"fused_ffn: m {m}, d {d}, f {f}: want 1..32 rows, d and f % 32 == 0")
    grid = max(1, sm_count)
    nt = planar_nt(m)
    nblk = (d // 32, f // 32)
    tiles = (f // 8, d // PLANAR_TILE)
    cap = PLANAR_X_FLOATS // (32 * m)
    ks = 64 if cap >= 64 else 32 if cap >= 32 else 16
    kc = min(-(-max(nblk) // ks) * ks, cap // ks * ks)
    slot = planar_slot_bytes(ks, nblk)
    max_tiles = max(-(-t // grid) for t in tiles)
    part = 16 * PLANAR_TILE * 8 * 4           # each warp's sums: 16 rows of its n8 tile
    while True:
        x = m * (kc * 64 + PLANAR_XPAD) * 4
        acc = max_tiles * PLANAR_TILE * m * 4 if any(nb > kc for nb in nblk) else 0
        stages = min(MAX_STAGES, (SMEM_LIMIT - HEADER_BYTES - x - part - acc) // slot)
        if stages >= PLANAR_MIN_STAGES or kc == ks:
            break
        kc -= ks
    if stages < 2:
        raise ValueError(f"fused_ffn: m {m}, d {d}, f {f} leave no room for two {slot}-byte "
                         f"stages")
    return PlanarPlan(grid, stages, slot, x, part, acc, HEADER_BYTES + stages * slot + x + part
                      + acc, ks, kc, max(1, AHEAD_BYTES // slot), max_tiles, nt, tiles, nblk)


def planar_ints(plan: PlanarPlan) -> list[int]:
    """The host ints csrc/ffn_planar.cu's launcher reads."""
    return [plan.grid, plan.stages, plan.slot_bytes, plan.x_bytes, plan.part_bytes,
            plan.acc_bytes, plan.smem_bytes, plan.ks, plan.kc, plan.ahead, plan.max_tiles]


_planar: dict[tuple, tuple] = {}


def planar_args(device: torch.device, m: int, d: int, f: int) -> tuple[PlanarPlan, ctypes.Array]:
    """(plan, host ints as a ctypes array) of planar_plan on `device`'s
    card, cached per card and shape."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = (index, m, d, f)
    with _lock:
        hit = _planar.get(key)
        if hit is None:
            plan = planar_plan(m, d, f, sm_count(index))
            ints = planar_ints(plan)
            hit = _planar[key] = (plan, (ctypes.c_int * len(ints))(*ints))
    return hit


DECODE_GROUP = 32         # csrc/decode_attn.cu: keys a warp scores at once (one a lane)
DECODE_WARPS = 4
DECODE_MAX_SPLIT = 16


def decode_splits(b: int, hkv: int, s: int, hd: int, sm_count: int,
                  unit: int = DECODE_GROUP * DECODE_WARPS, per_sm: int | None = None) -> int:
    """K4's and K8's blocks per (batch row, KV head): as many as the card
    holds at once (`per_sm` an SM; K4: two at head_dim <= 64, whose tiles
    take ~85 KB of shared memory, one above), at most DECODE_MAX_SPLIT (the
    last block merges every split's partial) and no more than an S-row cache
    has units of `unit` keys (a block's warps' groups; K8's I8PV mode: its
    JAX block, attention.k8_block)."""
    most = max(1, -(-s // unit))
    per_sm = per_sm or (2 if hd <= 64 else 1)
    return max(1, min(DECODE_MAX_SPLIT, most, per_sm * sm_count // max(1, b * hkv)))


def decode_split_keys(kv_len: int, s: int, n_split: int, split: int,
                      unit: int = DECODE_GROUP) -> tuple[int, int]:
    """Keys [k0, k1) of split `split` for a row of kv_len keys (clipped to
    [0, s]): units of `unit` keys (32-key groups; K8's I8PV mode: whole JAX
    blocks), split balanced over n_split."""
    length = max(0, min(kv_len, s))
    g = -(-length // unit)
    g0, g1 = split * g // n_split, (split + 1) * g // n_split
    return min(g0 * unit, length), min(g1 * unit, length)


def host_ints(plan: StreamPlan) -> list[int]:
    """The plan as the launchers read it: grid, stages, slot_bytes,
    act_bytes, smem_bytes, mr, phases, ahead, then PHASE_INTS per phase."""
    out = [plan.grid, plan.stages, plan.slot_bytes, plan.act_bytes, plan.smem_bytes, plan.mr,
           len(plan.phases), plan.ahead]
    for ph in plan.phases:
        out += [ph.segs, ph.seg_off, ph.unit_rows, ph.group_units, ph.group_rows, ph.unit_max]
    return out


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_lock = threading.Lock()
_args: dict[tuple, tuple] = {}


def launch_args(device: torch.device, make, *key) -> tuple[StreamPlan, ctypes.Array, torch.Tensor]:
    """(plan, host ints as a ctypes array, device int32 [phases, grid + 1]
    of range bounds) for `make(*key, sm_count)`, cached per card and key."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    ck = (index, make.__name__, *key)
    with _lock:
        hit = _args.get(ck)
        if hit is None:
            plan = make(*key, sm_count(index))
            ints = host_ints(plan)
            bounds = torch.tensor([ph.bounds for ph in plan.phases], dtype=torch.int32,
                                  device=torch.device("cuda", index))
            hit = (plan, (ctypes.c_int * len(ints))(*ints), bounds)
            _args[ck] = hit
    return hit
