"""Quantized matmul kernels (Q4_0 and Q8_0) and their plain versions.

  K2  qmatmul_cuda / qmatmul_ref        (csrc/qmatmul.cu) counterpart of
      zgml_tpu/ops/qmatmul.py `_q4_kernel` (K2q4) and `_q8_kernel` (K2q8):
      f32 dequant, any M; a GEMV up to GEMV_MAX_M rows, above that split-TF32
      `wgmma` with K split across blocks by ``qmatmul_plan``. Its bf16 form
      (bf16=True: JAX's dot_bf16, qmatmul.py:57-63, 113-121) computes
      sum_k bf16(x) * bf16(level * scale) with f32 sums: the GEMV's bf16 mode
      up to GEMV_MAX_M rows, above that a bf16 `wgmma` GEMM. ``bf16_tier``
      says which calls take it (JAX's row tile ``row_tile`` of at least 32
      rows, no int8 tier, ZGML_TPU_PREFILL_BF16 on).
  K1  qmatmul_i8_cuda / qmatmul_i8_ref  (csrc/qmatmul_i8.cu) counterpart of
      `_q4_i8_kernel` (K1q4) and `_q8_i8_kernel` (K1q8): int8 activations per
      32-block, exact int8 block dots (int8 tensor cores), f32 scale and sum;
      the tier for M <= 32, one launch a call on the plan ``i8_plan``.
  K5  greedy_cuda / greedy_ref          (csrc/qmatmul_i8.cu) counterpart of
      `_q4_i8_argmax_kernel` (K5q4) / `_q8_i8_argmax_kernel` (K5q8) through
      `qmatmul_greedy_pallas`: K1 on one row (K1's M = 1 plan and code), then
      the argmax id (first index on ties).
  K11 qmatmul_bwd_cuda / qmatmul_bwd_ref (csrc/qmatmul_bwd.cu) counterpart of
      `_q4_bwd_kernel` (K11q4) and `_q8_bwd_kernel` (K11q8) under
      `_qmm_diff_bwd`: dx = g @ dequant(W), f32, in logical k order, on TF32
      tensor cores with g * scale split in two TF32 parts; N is split across
      blocks by ``qmatmul_bwd_plan``.
      ``QMatmul`` is the counterpart of `_qmm_diff`: its backward is K11 for
      both forward tiers (K1 straight through its rounding, as JAX's), and the
      weight planes get no gradient (frozen quantized weights).

Each wrapper launches the kernel of its weight's kind and counts the launch
under `counter(name, w.kind)` (K2's bf16 form under `counter(name, w.kind,
bf16=True)`, qmatmul_bf16 / qmatmul_bf16_q8). Callers go through ``ops.dispatch``, which
picks the tier (config.i8dot(), M) and between kernel and plain version by
device.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading
from typing import NamedTuple

import torch

from zgml_tpu_torch import config
from zgml_tpu_torch.ops import build, coop, refs
from zgml_tpu_torch.ops.decode_plan import (AHEAD_BYTES, HEADER_BYTES, MAX_STAGES, SLOT_ALIGN,
                                            SMEM_LIMIT, sm_count)
from zgml_tpu_torch.quant.blocks import QK
from zgml_tpu_torch.quant.packed import QS_BLOCK_BYTES, PackedWeight
from zgml_tpu_torch.runtime.profile import global_profile

qmatmul_ref = refs.qmatmul_ref

I8_MAX_ROWS = 32        # K1 serves M <= 32 (zgml_tpu/ops/qmatmul.py:639,728)
KIND_CODE = {"q4_0": 0, "q8_0": 1}     # the kind argument of the csrc launchers


def counter(name: str, kind: str, bf16: bool = False) -> str:
    """The placement counter of kernel `name` at weight kind `kind`: the
    Q4_0 kernels count under their plain name, the Q8_0 ones with _q8; K2's
    bf16 form adds _bf16 to the name (qmatmul_bf16, qmatmul_bf16_q8)."""
    name = f"{name}_bf16" if bf16 else name
    return name if kind == "q4_0" else f"{name}_q8"


BF16_MIN_TILE = 32      # JAX's bf16 tier: a row tile of at least 32 rows (qmatmul.py:646)


def _choose_tile(total: int, limit: int, mult: int) -> int:
    """The largest multiple of `mult` that divides `total` and is <= limit,
    else total (zgml_tpu/ops/qmatmul.py `_choose_tile`)."""
    for cand in range(min(limit, total) // mult * mult, 0, -mult):
        if total % cand == 0:
            return cand
    return total


def row_tile(m: int) -> int:
    """The JAX package's row tile bm of an m-row call (qmatmul.py:716, 727):
    m padded to a multiple of 8 (at least 8), whole up to 512 rows, else its
    largest divisor that is a multiple of 8 and <= 256."""
    m_pad = max(8, -(-m // 8) * 8)
    return m_pad if m_pad <= 512 else _choose_tile(m_pad, 256, 8)


def bf16_tier(rows: int, i8: bool) -> bool:
    """Whether a K2 call standing for `rows` rows computes the bf16-operand
    function, as `_qmm_diff` decides dot_bf16 (qmatmul.py:636-648): the int8
    tier (i8) does not take it, JAX's row tile holds at least 32 rows, and
    ZGML_TPU_PREFILL_BF16 is on. m_pad = 8 p for a prime p > 64 gives
    bm = 8: such calls stay f32."""
    return not i8 and row_tile(rows) >= BF16_MIN_TILE and config.prefill_bf16()


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"qmatmul: {msg}")


def _check(x: torch.Tensor, w: PackedWeight):
    _require(x.is_cuda and w.qs.device == x.device and w.d.device == x.device,
             f"x on {x.device}, weight on {w.qs.device}: all must be on one CUDA device")
    _require(x.dtype == torch.float32, f"x must be float32, got {x.dtype}")
    _require(x.shape[-1] == w.k, f"x has K={x.shape[-1]}, weight K={w.k}")
    _require(x.is_contiguous() and w.qs.is_contiguous() and w.d.is_contiguous(),
             "x and the weight planes must be contiguous")
    _require(x.data_ptr() % 16 == 0 and w.qs.data_ptr() % 16 == 0,
             "x and qs must be 16-byte aligned")


# K2's tiled tier (csrc/qmatmul.cu): 128 x 128 tiles of y, K stepped one
# quant block a stage (the bf16 form: two); M <= GEMV_MAX_M runs the GEMV,
# which takes no plan
GEMV_MAX_M = 4
FWD_BM, FWD_BN = 128, 128
FWD_MAX_SPLIT = 16
FWD_MIN_STAGES = 8        # a part of K takes at least 8 quant blocks
# the plan's cost model: a resident block's time for one stage (~1 us on
# the H100: Llama-2-7B's lm_head at M 128, 2 waves x 128 stages, takes ~253
# us; PERF.md), and the rate at which the partials are written and read back
# (HBM's). The bf16 form's stage (64 k, one bf16 product where TF32 takes
# two at half the rate) is put at half the TF32 one's time: an estimate
FWD_STAGE_US = 1.0
FWD_STAGE_US_BF16 = 0.5
FWD_PART_BYTES_PER_US = 3.35e6
BF16_STAGE_BLOCKS = 2     # quant blocks a stage of the bf16 form takes


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    """K2's launch at M > GEMV_MAX_M: n_split parts of K; part z takes the
    quant blocks parts[z] = [begin, end) (the kernel computes them from its
    grid z)."""
    n_split: int
    parts: tuple[tuple[int, int], ...]


def qmatmul_plan(m: int, n: int, k: int, sm_count: int, per_sm: int = 1,
                 bf16: bool = False) -> FwdPlan:
    """Split K so that the tiles of y times the parts fill the card's
    resident blocks (sm_count * per_sm): the least estimated time, waves x
    stages of the longest part at FWD_STAGE_US (bf16: FWD_STAGE_US_BF16 a
    stage of BF16_STAGE_BLOCKS quant blocks) plus the partials' traffic
    (written and read back, and y written) at FWD_PART_BYTES_PER_US, the
    fewest parts on a tie, no part shorter than FWD_MIN_STAGES quant blocks
    unless K has fewer. Parts are whole quant blocks (a bf16 part of an odd
    count ends on a half stage). A pure function of the shapes and the
    card, so y has the same bits on every run there."""
    tiles = -(-m // FWD_BM) * -(-n // FWD_BN)
    blocks = k // QK
    per_stage, stage_us = (BF16_STAGE_BLOCKS, FWD_STAGE_US_BF16) if bf16 else (1, FWD_STAGE_US)
    slots = max(1, sm_count * per_sm)
    most = max(1, min(FWD_MAX_SPLIT, blocks // FWD_MIN_STAGES))

    def cost(s):
        run = -(-tiles * s // slots) * -(-blocks // (s * per_stage)) * stage_us
        return run + (0 if s == 1 else (2 * s + 1) * m * n * 4 / FWD_PART_BYTES_PER_US)
    n_split = min(range(1, most + 1), key=lambda s: (cost(s), s))
    bounds = [z * blocks // n_split for z in range(n_split + 1)]
    return FwdPlan(n_split, tuple(zip(bounds[:-1], bounds[1:])))


@functools.lru_cache(maxsize=None)
def _card(index: int, kind: str, query: str, what: str) -> tuple[int, int]:
    """(SM count, blocks of a kernel one SM holds) of card `index` at `kind`,
    from the library's occupancy query `query`."""
    n = ctypes.c_int(0)
    with torch.cuda.device(index):
        build.check(getattr(build.library(), query)(KIND_CODE[kind], ctypes.byref(n)),
                    f"{what} occupancy")
    if n.value < 1:
        raise RuntimeError(f"{what} ({kind}): no block fits on an SM")
    return torch.cuda.get_device_properties(index).multi_processor_count, n.value


def _fwd_card(index: int, kind: str, bf16: bool = False) -> tuple[int, int]:
    """(SM count, K2 tiled blocks one SM holds) of card `index` at `kind`
    (the bf16 form's GEMM with bf16)."""
    if bf16:
        return _card(index, kind, "zgml_qmatmul_bf16_blocks_per_sm", "qmatmul_bf16")
    return _card(index, kind, "zgml_qmatmul_blocks_per_sm", "qmatmul")


def qmatmul_cuda(x: torch.Tensor, w: PackedWeight, bf16: bool = False,
                 xb_out: torch.Tensor | None = None) -> torch.Tensor:
    """K2: x f32 [..., K] (contiguous, on the card) @ dequant(W).T -> f32
    [..., N]; with bf16 its bf16 form (bf16(x) . bf16(level * scale), f32
    sums). xb_out (bf16 [M, K], contiguous), above GEMV_MAX_M rows in the
    bf16 form, receives the pre-pass's bf16(x) (a check holds it to x
    rounded by torch)."""
    _check(x, w)
    lead = x.shape[:-1]
    m = x.numel() // w.k
    y = torch.empty((*lead, w.n), dtype=torch.float32, device=x.device)
    if m == 0:
        return y
    n_split, part, xb = 1, None, None
    if m > GEMV_MAX_M:
        n_split = qmatmul_plan(m, w.n, w.k, *_fwd_card(x.device.index or 0, w.kind, bf16),
                               bf16=bf16).n_split
        if n_split > 1:
            part = torch.empty((n_split, m, w.n), dtype=torch.float32, device=x.device)
        if bf16:        # the kernel's pre-pass writes bf16(x) here, once for every tile
            xb = xb_out if xb_out is not None else torch.empty(
                (m, w.k), dtype=torch.bfloat16, device=x.device)
            _require(xb.dtype == torch.bfloat16 and xb.numel() == m * w.k
                     and xb.is_contiguous() and xb.device == x.device
                     and xb.data_ptr() % 16 == 0,
                     f"xb_out takes a contiguous 16-byte aligned bf16 [{m}, {w.k}] tensor")
    status = build.library().zgml_qmatmul(
        KIND_CODE[w.kind], x.data_ptr(), w.qs.data_ptr(), w.d.data_ptr(), y.data_ptr(),
        None if part is None else part.data_ptr(), None if xb is None else xb.data_ptr(), m,
        w.n, w.k, n_split, int(bf16), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "qmatmul_bf16" if bf16 else "qmatmul")
    global_profile.count_op(counter("qmatmul", w.kind, bf16), "cuda")
    return y


# -- K1 / K5: the int8-activation tier -----------------------------------------

def quantize_act_ref(x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x f32 [M, K] -> (xq int8 [M, K], xs f32 [M, K/32]) as the JAX
    `_quantize_act` (qmatmul.py:181-190): s = amax/127, inv = 1/s (0 where
    s == 0), xq = clip(round_half_even(x * inv), -127, 127)."""
    m, k = x2.shape
    xb = x2.to(torch.float32).reshape(m, k // QK, QK)
    amax = xb.abs().amax(dim=-1)
    # tensor / tensor: a true division on every device (on CUDA, torch turns
    # division by a Python scalar into a multiply by its reciprocal)
    s = amax / torch.full_like(amax, 127.0)
    one = torch.ones_like(s)
    inv = torch.where(s > 0, one / torch.where(s > 0, s, one), torch.zeros_like(s))
    q = torch.clamp(torch.round(xb * inv[..., None]), -127, 127).to(torch.int8)
    return q.reshape(m, k), s


def rmsnorm_quantize_ref(x: torch.Tensor, gamma: torch.Tensor,
                         eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The int8 pre-pass of K7's and K6's i8a modes, the norm folded in, as
    the JAX package computes it (layerkernel.py:782-786, ffn.py:530-532):
    n = x * rsqrt(sum(x^2) * (1/d) + eps) * gamma, then quantize_act_ref(n).
    x f32 [..., d] -> (xq int8 [M, d], xs f32 [M, d/32])."""
    d = x.shape[-1]
    x2 = x.reshape(-1, d).to(torch.float32)
    ms = torch.sum(x2 * x2, dim=-1, keepdim=True) * (1.0 / d)
    return quantize_act_ref(x2 * torch.rsqrt(ms + eps) * gamma.to(torch.float32))


def i8_dot_ref(xq: torch.Tensor, xs: torch.Tensor, w: PackedWeight) -> torch.Tensor:
    """K1's block dots on given activations: xq int8 [M, K], xs f32 [M, K/32]
    -> f32 [M, N] = sum_b float(sum_j xq_bj level_bj) * (xs_b * d_b). The
    integer dots are taken in f32 on values below 2^24, so they are exact,
    as on the card."""
    nb = w.k // QK
    p = torch.einsum("mbj,nbj->mnb", xq.view(-1, nb, QK).to(torch.float32),
                     w.levels().to(torch.float32))                          # [M, N, nb]
    return (p * (xs[:, None, :] * w.d.to(torch.float32)[None])).sum(dim=-1)


def qmatmul_i8_ref(x: torch.Tensor, w: PackedWeight) -> torch.Tensor:
    """K1's plain version: x f32 [..., K] -> f32 [..., N]."""
    lead = x.shape[:-1]
    return i8_dot_ref(*quantize_act_ref(x.reshape(-1, w.k)), w).reshape(*lead, w.n)


def greedy_ref(x: torch.Tensor, w: PackedWeight) -> torch.Tensor:
    """K5's plain version: one row x [..., K] -> int64 [1], the first argmax
    of qmatmul_i8_ref(x, w)."""
    return torch.argmax(qmatmul_i8_ref(x.reshape(1, w.k), w)[0]).reshape(1)


# K1 / K5's launch (csrc/qmatmul_i8.cu): one block an SM, 16 consumer warps
# and a producer warp streaming the block's 16-row tiles, S at a time
I8_TILE = 16               # weight rows an MMA tile (the A operand of m16n8k32)
I8_SEG = 128               # bytes of a row one warp's item covers
I8_WARPS = 16              # consumer warps (csrc/weight_stream.cuh ws::WARPS)
I8_SELF_MAX_MK = 8192      # M * K up to which every block quantizes x itself (no grid barrier)
I8_STAGE_BYTES = 72 * 1024    # a stage's size to aim at (72 KB beat 32 KB on the H100: PERF.md)
I8_RED_BYTES = 256         # K5's per-warp (value, row) pairs and its last-block flag


class I8Plan(NamedTuple):
    """K1's launch for m rows (K5: m = 1). The grid's `tiles` tiles of tr
    rows (16: the MMA's A operand; 8 where two 16-row slots do not fit, the
    MMA's other 8 rows idle) are split into contiguous ranges, block b taking
    [b * tiles // grid, (b + 1) * tiles // grid), streamed S tiles a stage
    (whole rows: one bulk copy of qs and one of the scales) through `stages`
    slots. self_q: every block quantizes x itself from a copy at xin_off;
    else the blocks quantize their share into a global xq and pass a grid
    barrier, then stage it at xf_off / xs_off, or, xg, read it from L2 in the
    dot. A stage of st tiles splits each tile into i8_parts(plan, st) parts
    of its nseg 128-byte segments (contiguous ranges), each taken by
    i8_groups(nt) warps (one a column group of x's rows); each output's part
    sums are added in part order at part_off (two buffers, stage by stage in
    turn, where nt <= 2; where nt is 4 and a slot holds them, pis, in the
    slot just consumed, and part takes none).

    kc > 1 is the K-split form, for rows so long that no 8-row tile of whole
    rows leaves a slot: each tile's rows are cut into kc pieces of
    consecutive quant blocks (`i8_piece`), a unit is (tile, piece), the
    grid's tiles * kc units are split as the tiles are above, a stage is one
    unit (S 1; nseg: the longest piece's segments), and each unit's sums go
    to a global [kc, M, N] area; after one grid barrier each output is the
    sum of its kc pieces in piece order."""
    grid: int
    stages: int
    slot_bytes: int
    S: int
    ahead: int
    self_q: bool
    xg: bool
    nt: int
    xin_off: int
    xf_off: int
    xs_off: int
    part_off: int
    red_off: int
    smem_bytes: int
    tr: int
    pis: bool
    tiles: int
    nseg: int
    kc: int = 1


def i8_nt(m: int) -> int:
    """n8 tiles of m rows of x (the kernel's instantiations: 1, 2, 4)."""
    return 1 if m <= 8 else 2 if m <= 16 else 4


def i8_groups(nt: int) -> int:
    """Column groups a tile's warps split x's rows in (2 at four n8 tiles:
    a warp then keeps two tiles' accumulators)."""
    return 2 if nt == 4 else 1


def _align(n: int) -> int:
    return -(-n // SLOT_ALIGN) * SLOT_ALIGN


def i8_plan(m: int, n: int, k: int, kind: str, sm_count: int) -> I8Plan:
    """K1's plan (a pure function of the shapes, the kind and the SM count,
    so y has the same bits on every run of a card). S: enough tiles that a
    stage's segments give every warp work, I8_STAGE_BYTES' worth where that
    is more, at most the tiles a block has, then the largest S up to that
    whose segments split evenly over the warps. The first mode whose areas leave a ring of
    two slots (or of the stages a block runs) wins, in order: self
    quantization (m * k <= I8_SELF_MAX_MK), the global xq staged in shared
    memory, the global xq read from L2; within a mode the largest S down to
    1; 16-row tiles first, then 8-row ones, then 8-row ones in a ring of one
    slot (no copy overlaps the dots). Where even that finds no room (Q8_0
    rows from k 27,040, Q4_0 from 51,072), the K-split form with the fewest
    pieces whose 16-row unit leaves two slots (`_i8_split_plan`)."""
    if not (1 <= m <= 32 and n >= 1 and k >= 32 and k % QK == 0):
        raise ValueError(f"qmatmul_i8: m {m}, n {n}, k {k}: want 1..32 rows, k % 32 == 0")
    grid = max(1, sm_count)
    nb, bpb = k // QK, QS_BLOCK_BYTES[kind]
    rq = nb * bpb
    nseg = -(-rq // I8_SEG)
    nt = i8_nt(m)
    mx = 8 * nt
    # the stages' partial sums: two buffers (one barrier a stage) up to 16
    # rows; above, in the slot just consumed where it holds them (pis)
    part1 = I8_WARPS * I8_TILE * (1 if m == 1 else mx) * 4    # M == 1: C's column 0 alone
    modes = ([(True, False)] if m * k <= I8_SELF_MAX_MK else []) + [(False, False),
                                                                   (False, True)]
    for tr, least in ((I8_TILE, 2), (I8_TILE // 2, 2), (I8_TILE // 2, 1)):
        tile_bytes = tr * nb * (bpb + 2)
        tiles = -(-n // tr)
        per_block = -(-tiles // grid)
        wk = I8_WARPS // i8_groups(nt)      # warps a stage's parts of K go to
        s_pref = max(1, min(wk, per_block, max(-(-wk // nseg), I8_STAGE_BYTES // tile_bytes)))
        # the largest S up to that whose segments split evenly over the warps
        even = [s for s in range(-(-wk // nseg), s_pref + 1) if s * nseg % wk == 0]
        s_pref = max(even, default=s_pref)
        for self_q, xg in modes:
            xin = _align(m * k * 4) if self_q else 0
            xf = 0 if xg else _align(m * k)
            xs = 0 if xg else _align(nb * mx * 4)
            for S in range(s_pref, 0, -1):
                slot = _align(S * tile_bytes)
                pis = nt == 4 and slot >= part1
                part = 0 if pis else part1 * (2 if nt <= 2 else 1)
                areas = xin + xf + xs + part + I8_RED_BYTES
                need = -(-per_block // S)
                stages = min(MAX_STAGES, (SMEM_LIMIT - HEADER_BYTES - areas) // slot, need)
                if stages >= min(least, need):
                    xin_off = HEADER_BYTES + stages * slot
                    xf_off = xin_off + xin
                    xs_off = xf_off + xf
                    part_off = xs_off + xs
                    red_off = part_off + part
                    return I8Plan(grid, stages, slot, S, max(1, AHEAD_BYTES // slot), self_q,
                                  xg, nt, xin_off, xf_off, xs_off, part_off, red_off,
                                  red_off + I8_RED_BYTES, tr, pis, tiles, nseg)
    return _i8_split_plan(m, n, k, kind, grid)


def _i8_split_plan(m: int, n: int, k: int, kind: str, grid: int, kc_least: int = 2) -> I8Plan:
    """The K-split form (I8Plan, kc > 1) with the fewest pieces from kc_least
    on whose 16-row unit leaves two slots (or the units a block runs); x
    goes to the global xq and is read from L2 (xg: at such K its staged
    rows take the room of a slot). M = 1 runs the n8 code of 2-8 rows (its
    one-row form spilled at ptxas' 96-register cap), so the part area holds
    8 columns at every M."""
    nb, bpb = k // QK, QS_BLOCK_BYTES[kind]
    nt = i8_nt(m)
    mx = 8 * nt
    part1 = I8_WARPS * I8_TILE * mx * 4
    tiles = -(-n // I8_TILE)
    g = i8_piece_align(nb)
    for kc in range(kc_least, nb // g + 1):
        nbc = -(-nb // g // kc) * g
        slot = _align(I8_TILE * nbc * (bpb + 2))
        pis = nt == 4 and slot >= part1
        part = 0 if pis else part1 * (2 if nt <= 2 else 1)
        need = -(-tiles * kc // grid)
        stages = min(MAX_STAGES, (SMEM_LIMIT - HEADER_BYTES - part - I8_RED_BYTES) // slot, need)
        if stages >= min(2, need):
            off = HEADER_BYTES + stages * slot
            return I8Plan(grid, stages, slot, 1, max(1, AHEAD_BYTES // slot), False, True, nt,
                          off, off, off, off, off + part, off + part + I8_RED_BYTES, I8_TILE,
                          pis, tiles, -(-nbc * bpb // I8_SEG), kc)
    raise ValueError(f"qmatmul_i8: a 16-row tile of {kind} rows of k {k} leaves no room for "
                     f"a slot")


def i8_piece_align(nb: int) -> int:
    """Quant blocks a K-split piece's bounds are a multiple of: 8 where the
    row's nb is (each piece's fp16 scales then a whole number of 16-byte
    bulk copies, staged beside its levels), else 1 (read from global memory
    in the dot)."""
    return 8 if nb % 8 == 0 else 1


def i8_piece(plan: I8Plan, nb: int, j: int) -> tuple[int, int]:
    """(first quant block, blocks) of piece j of a row of nb quant blocks:
    [j * (nb / g) // kc * g, (j + 1) * (nb / g) // kc * g), g =
    i8_piece_align(nb) (the whole row where kc is 1)."""
    g = i8_piece_align(nb)
    b0 = j * (nb // g) // plan.kc * g
    return b0, (j + 1) * (nb // g) // plan.kc * g - b0


def i8_ints(plan: I8Plan) -> list[int]:
    """The host ints csrc/qmatmul_i8.cu's launchers read."""
    return [plan.grid, plan.stages, plan.slot_bytes, plan.S, plan.ahead, int(plan.self_q),
            int(plan.xg), plan.nt, plan.xin_off, plan.xf_off, plan.xs_off, plan.part_off,
            plan.red_off, plan.smem_bytes, plan.tr, int(plan.pis), plan.kc]


def i8_block_tiles(plan: I8Plan, b: int) -> tuple[int, int]:
    """Units [t0, t1) of block b: tiles, or in the K-split form (tile, piece)
    units u = tile * kc + piece."""
    units = plan.tiles * plan.kc
    return b * units // plan.grid, (b + 1) * units // plan.grid


def i8_stages(plan: I8Plan, b: int) -> list[tuple[int, int]]:
    """(first unit, units) of each stage of block b."""
    t0, t1 = i8_block_tiles(plan, b)
    return [(u, min(plan.S, t1 - u)) for u in range(t0, t1, plan.S)]


def i8_parts(plan: I8Plan, st: int, nseg: int | None = None) -> int:
    """Parts of K a tile of a stage of st tiles is split in (each taken by
    i8_groups(plan.nt) warps); nseg: the stage's segments a row (a K-split
    piece's own), plan.nseg by default."""
    nseg = plan.nseg if nseg is None else nseg
    return min(I8_WARPS // (i8_groups(plan.nt) * st), nseg)


def i8_part_segments(plan: I8Plan, st: int, part: int, nseg: int | None = None) -> range:
    """The 128-byte segments of a tile that part `part` of a stage of st
    tiles takes (contiguous, in order)."""
    nseg = plan.nseg if nseg is None else nseg
    p = i8_parts(plan, st, nseg)
    return range(part * nseg // p, (part + 1) * nseg // p)


def i8_scratch_bytes(plan: I8Plan, m: int, k: int, greedy: bool = False, n: int = 0) -> int:
    """Bytes of the launch's global scratch: the global xq (m * k, rounded
    to 16) and its staged scales; K5 adds each block's best value and row,
    the K-split form (K1 of n outputs) its [kc, m, n] piece sums."""
    xq = -(-m * k // 16) * 16
    split = plan.kc * m * n * 4 if plan.kc > 1 else 0
    return xq + k // QK * 8 * plan.nt * 4 + (8 * plan.grid if greedy else 0) + split


_lock = threading.Lock()
_i8_args: dict[tuple, tuple] = {}


def i8_args(device: torch.device, m: int, n: int, k: int, kind: str
            ) -> tuple[I8Plan, ctypes.Array]:
    """(plan, host ints as a ctypes array) of i8_plan on `device`'s card,
    cached per card and shape."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = (index, m, n, k, kind)
    with _lock:
        hit = _i8_args.get(key)
        if hit is None:
            plan = i8_plan(m, n, k, kind, sm_count(index))
            ints = i8_ints(plan)
            hit = _i8_args[key] = (plan, (ctypes.c_int * len(ints))(*ints))
    return hit


def quantize_act_cuda(x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's activation pre-pass alone, on the card: x f32 [M, K] -> (xq, xs),
    bit-equal to quantize_act_ref (so a check can hold it to the plain one).
    K1 and K5 run the same device function inside their launch."""
    _require(x2.is_cuda and x2.dtype == torch.float32 and x2.dim() == 2
             and x2.is_contiguous() and x2.shape[1] % QK == 0,
             f"x must be a contiguous float32 [M, K % 32 == 0] CUDA tensor, got "
             f"{x2.dtype} {tuple(x2.shape)} on {x2.device}")
    xq = torch.empty(x2.shape, dtype=torch.int8, device=x2.device)
    xs = torch.empty((x2.shape[0], x2.shape[1] // QK), dtype=torch.float32, device=x2.device)
    status = build.library().zgml_i8_quantize(
        x2.data_ptr(), xq.data_ptr(), xs.data_ptr(), x2.shape[0], x2.shape[1],
        torch.cuda.current_stream(x2.device).cuda_stream)
    build.check(status, "i8_quantize")
    return xq, xs


def _act_ptrs(act_out, m: int, k: int, device) -> tuple[int | None, int | None]:
    if act_out is None:
        return None, None
    xq, xs = act_out
    _require(xq.dtype == torch.int8 and xq.numel() == m * k and xs.dtype == torch.float32
             and xs.numel() == m * k // QK
             and all(t.device == device and t.is_contiguous() for t in act_out),
             f"act_out takes int8 [{m}, {k}] and float32 [{m}, {k // QK}] contiguous "
             f"tensors on {device}")
    return xq.data_ptr(), xs.data_ptr()


def qmatmul_i8_cuda(x: torch.Tensor, w: PackedWeight, act_out=None) -> torch.Tensor:
    """K1: x f32 [..., K] with at most 32 rows -> f32 [..., N]. act_out =
    (xq int8 [M, K], xs f32 [M, K/32]) receives the kernel's own int8
    activations (a check holds them to quantize_act_ref)."""
    _check(x, w)
    lead = x.shape[:-1]
    m = x.numel() // w.k
    _require(m <= I8_MAX_ROWS, f"the int8 tier takes M <= {I8_MAX_ROWS} rows, got {m}")
    y = torch.empty((*lead, w.n), dtype=torch.float32, device=x.device)
    if m == 0:
        return y
    _require(w.d.data_ptr() % 16 == 0, "the weight's scales must be 16-byte aligned")
    plan, ints = i8_args(x.device, m, w.n, w.k, w.kind)
    xq_p, xs_p = _act_ptrs(act_out, m, w.k, x.device)
    scratch = (None if plan.self_q and plan.kc == 1
               else coop.scratch(x.device, i8_scratch_bytes(plan, m, w.k, n=w.n)))
    status = build.library().zgml_qmatmul_i8(
        KIND_CODE[w.kind], x.data_ptr(), w.qs.data_ptr(), w.d.data_ptr(), y.data_ptr(),
        xq_p, xs_p, None if scratch is None else scratch.data_ptr(),
        coop.barrier_words(x.device).data_ptr(), m, w.n, w.k, ints, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "qmatmul_i8")
    global_profile.count_op(counter("qmatmul_i8", w.kind), "cuda")
    return y


def qmatmul_bwd_ref(g: torch.Tensor, w: PackedWeight) -> torch.Tensor:
    """K11's plain version: g f32 [..., N] -> dx = g @ dequant(W) f32 [..., K]."""
    lead = g.shape[:-1]
    return (g.reshape(-1, w.n).to(torch.float32) @ w.dequant()).reshape(*lead, w.k)


# K11's tiling (csrc/qmatmul_bwd.cu): 128 x 128 tiles of dx (BWD_BKB quant
# blocks of k), the contraction N stepped BWD_BN rows a stage
BWD_BM, BWD_BKB, BWD_BN = 128, 4, 32
BWD_MAX_SPLIT = 16
BWD_MIN_STAGES = 8        # a part of N takes at least 8 stages (256 rows)


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """K11's launch: n_split parts of N; part z takes the rows
    parts[z] = [begin, end), whole stages of BWD_BN rows (the last part ends
    at N), as the kernel computes them from its grid z."""
    n_split: int
    parts: tuple[tuple[int, int], ...]


def qmatmul_bwd_plan(m: int, n: int, k: int, sm_count: int, per_sm: int = 1) -> BwdPlan:
    """Split N so that the tiles of dx times the parts fill whole waves of
    the card's resident blocks (sm_count * per_sm): the least waves times
    stages of the longest part, the fewest parts on a tie, no part shorter
    than BWD_MIN_STAGES stages unless N has fewer. A pure function of the
    shapes and the card, so dx has the same bits on every run there."""
    tiles = -(-m // BWD_BM) * -(-(k // QK) // BWD_BKB)
    stages = -(-n // BWD_BN)
    slots = max(1, sm_count * per_sm)
    most = max(1, min(BWD_MAX_SPLIT, stages // BWD_MIN_STAGES))
    n_split = min(range(1, most + 1),
                  key=lambda s: (-(-tiles * s // slots) * -(-stages // s), s))
    bounds = [z * stages // n_split * BWD_BN for z in range(n_split)] + [n]
    return BwdPlan(n_split, tuple(zip(bounds[:-1], bounds[1:])))


def _bwd_card(index: int, kind: str) -> tuple[int, int]:
    """(SM count, K11 blocks one SM holds) of card `index` at `kind`."""
    return _card(index, kind, "zgml_qmatmul_bwd_blocks_per_sm", "qmatmul_bwd")


def qmatmul_bwd_cuda(g: torch.Tensor, w: PackedWeight) -> torch.Tensor:
    """K11: g f32 [..., N] (contiguous, on the card) -> dx f32 [..., K]."""
    _require(g.is_cuda and w.qs.device == g.device and w.d.device == g.device,
             f"g on {g.device}, weight on {w.qs.device}: all must be on one CUDA device")
    _require(g.dtype == torch.float32 and g.shape[-1] == w.n and g.is_contiguous(),
             f"g must be contiguous float32 [..., {w.n}], got {g.dtype} {tuple(g.shape)}")
    _require(w.qs.is_contiguous() and w.d.is_contiguous() and w.qs.data_ptr() % 16 == 0,
             "the weight planes must be contiguous and qs 16-byte aligned")
    lead = g.shape[:-1]
    m = g.numel() // w.n
    dx = torch.empty((*lead, w.k), dtype=torch.float32, device=g.device)
    if m == 0:
        return dx
    plan = qmatmul_bwd_plan(m, w.n, w.k, *_bwd_card(g.device.index or 0, w.kind))
    part = (torch.empty((plan.n_split, m, w.k), dtype=torch.float32, device=g.device)
            if plan.n_split > 1 else None)
    status = build.library().zgml_qmatmul_bwd(
        KIND_CODE[w.kind], g.data_ptr(), w.qs.data_ptr(), w.d.data_ptr(), dx.data_ptr(),
        None if part is None else part.data_ptr(), m, w.n, w.k, plan.n_split,
        torch.cuda.current_stream(g.device).cuda_stream)
    build.check(status, "qmatmul_bwd")
    global_profile.count_op(counter("qmatmul_bwd", w.kind), "cuda")
    return dx


class QMatmul(torch.autograd.Function):
    """x @ dequant(W).T with dx = g @ dequant(W): the counterpart of
    `_qmm_diff`. ``apply(x, w, fwd, bwd)`` runs fwd(x, w) (the tier the
    caller picked: K1, K2 or a plain version) and bwd(g, w) in backward
    (K11 or its plain version); the PackedWeight is a frozen constant."""

    @staticmethod
    def forward(ctx, x, w, fwd, bwd):
        ctx.w, ctx.bwd = w, bwd
        return fwd(x, w)

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(g.to(torch.float32).contiguous(), ctx.w), None, None, None


def greedy_cuda(x: torch.Tensor, w: PackedWeight) -> torch.Tensor:
    """K5: one row x f32 [..., K] -> int64 [1] on the card, equal to
    argmax(qmatmul_i8_cuda(x, w)) (K1's M = 1 plan and device code; on its
    K-split plan, kc > 1, the argmax of K1's split outputs, their pieces
    summed in K1's order). Counted under greedy_counter."""
    _check(x, w)
    _require(x.numel() == w.k, f"the greedy head takes one row, got {tuple(x.shape)}")
    _require(w.d.data_ptr() % 16 == 0, "the weight's scales must be 16-byte aligned")
    plan, ints = i8_args(x.device, 1, w.n, w.k, w.kind)
    out = torch.empty(1, dtype=torch.int64, device=x.device)
    scratch = coop.scratch(x.device, i8_scratch_bytes(plan, 1, w.k, greedy=True, n=w.n))
    status = build.library().zgml_greedy(
        KIND_CODE[w.kind], x.data_ptr(), w.qs.data_ptr(), w.d.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), coop.barrier_words(x.device).data_ptr(),
        coop.counter_words(x.device, 1).data_ptr(), w.n, w.k, ints, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "greedy")
    global_profile.count_op(greedy_counter(plan, w.kind), "cuda")
    return out


def greedy_counter(plan: I8Plan, kind: str) -> str:
    """K5's placement counter on `plan`: qmatmul_greedy (_q8), or
    qmatmul_greedy_ksplit (_q8) on K1's K-split form (kc > 1)."""
    return counter("qmatmul_greedy_ksplit" if plan.kc > 1 else "qmatmul_greedy", kind)
