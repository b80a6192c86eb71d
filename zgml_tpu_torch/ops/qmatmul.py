"""Quantized matmul kernels (Q4_0 and Q8_0) and their plain versions.

  K2  qmatmul_cuda / qmatmul_ref        (csrc/qmatmul.cu) counterpart of
      zgml_tpu/ops/qmatmul.py `_q4_kernel` (K2q4) and `_q8_kernel` (K2q8):
      f32 dequant, any M; a GEMV up to GEMV_MAX_M rows, above that split-TF32
      `wgmma` with K split across blocks by ``qmatmul_plan``.
  K1  qmatmul_i8_cuda / qmatmul_i8_ref  (csrc/qmatmul_i8.cu) counterpart of
      `_q4_i8_kernel` (K1q4) and `_q8_i8_kernel` (K1q8): int8 activations per
      32-block, exact int8 block dots, f32 scale and sum; the tier for M <= 32.
  K5  greedy_cuda / greedy_ref          (csrc/qmatmul_i8.cu) counterpart of
      `_q4_i8_argmax_kernel` (K5q4) / `_q8_i8_argmax_kernel` (K5q8) through
      `qmatmul_greedy_pallas`: K1 on one row, then the argmax id (first index
      on ties).
  K11 qmatmul_bwd_cuda / qmatmul_bwd_ref (csrc/qmatmul_bwd.cu) counterpart of
      `_q4_bwd_kernel` (K11q4) and `_q8_bwd_kernel` (K11q8) under
      `_qmm_diff_bwd`: dx = g @ dequant(W), f32, in logical k order, on TF32
      tensor cores with g * scale split in two TF32 parts; N is split across
      blocks by ``qmatmul_bwd_plan``.
      ``QMatmul`` is the counterpart of `_qmm_diff`: its backward is K11 for
      both forward tiers (K1 straight through its rounding, as JAX's), and the
      weight planes get no gradient (frozen quantized weights).

Each wrapper launches the kernel of its weight's kind and counts the launch
under `counter(name, w.kind)`. Callers go through ``ops.dispatch``, which
picks the tier (config.i8dot(), M) and between kernel and plain version by
device.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from zgml_tpu_torch.ops import build, refs
from zgml_tpu_torch.quant.blocks import QK
from zgml_tpu_torch.quant.packed import PackedWeight
from zgml_tpu_torch.runtime.profile import global_profile

qmatmul_ref = refs.qmatmul_ref

I8_MAX_ROWS = 32        # K1 serves M <= 32 (zgml_tpu/ops/qmatmul.py:639,728)
KIND_CODE = {"q4_0": 0, "q8_0": 1}     # the kind argument of the csrc launchers


def counter(name: str, kind: str) -> str:
    """The placement counter of kernel `name` at weight kind `kind`: the
    Q4_0 kernels count under their plain name, the Q8_0 ones with _q8."""
    return name if kind == "q4_0" else f"{name}_q8"


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
# quant block a stage; M <= GEMV_MAX_M runs the GEMV, which takes no plan
GEMV_MAX_M = 4
FWD_BM, FWD_BN = 128, 128
FWD_MAX_SPLIT = 16
FWD_MIN_STAGES = 8        # a part of K takes at least 8 quant blocks
# the plan's cost model: a resident block's time for one stage (~1 us on
# the H100: Llama-2-7B's lm_head at M 128, 2 waves x 128 stages, takes ~253
# us; PERF.md), and the rate at which the partials are written and read back
# (HBM's)
FWD_STAGE_US = 1.0
FWD_PART_BYTES_PER_US = 3.35e6


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    """K2's launch at M > GEMV_MAX_M: n_split parts of K; part z takes the
    quant blocks parts[z] = [begin, end) (the kernel computes them from its
    grid z)."""
    n_split: int
    parts: tuple[tuple[int, int], ...]


def qmatmul_plan(m: int, n: int, k: int, sm_count: int, per_sm: int = 1) -> FwdPlan:
    """Split K so that the tiles of y times the parts fill the card's
    resident blocks (sm_count * per_sm): the least estimated time, waves x
    stages of the longest part at FWD_STAGE_US plus the partials' traffic
    (written and read back, and y written) at FWD_PART_BYTES_PER_US, the
    fewest parts on a tie, no part shorter than FWD_MIN_STAGES quant blocks
    unless K has fewer. A pure function of the shapes and the card, so y
    has the same bits on every run there."""
    tiles = -(-m // FWD_BM) * -(-n // FWD_BN)
    stages = k // QK
    slots = max(1, sm_count * per_sm)
    most = max(1, min(FWD_MAX_SPLIT, stages // FWD_MIN_STAGES))

    def cost(s):
        run = -(-tiles * s // slots) * -(-stages // s) * FWD_STAGE_US
        return run + (0 if s == 1 else (2 * s + 1) * m * n * 4 / FWD_PART_BYTES_PER_US)
    n_split = min(range(1, most + 1), key=lambda s: (cost(s), s))
    bounds = [z * stages // n_split for z in range(n_split + 1)]
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


def _fwd_card(index: int, kind: str) -> tuple[int, int]:
    """(SM count, K2 tiled blocks one SM holds) of card `index` at `kind`."""
    return _card(index, kind, "zgml_qmatmul_blocks_per_sm", "qmatmul")


def qmatmul_cuda(x: torch.Tensor, w: PackedWeight) -> torch.Tensor:
    """K2: x f32 [..., K] (contiguous, on the card) @ dequant(W).T -> f32 [..., N]."""
    _check(x, w)
    lead = x.shape[:-1]
    m = x.numel() // w.k
    y = torch.empty((*lead, w.n), dtype=torch.float32, device=x.device)
    if m == 0:
        return y
    n_split, part = 1, None
    if m > GEMV_MAX_M:
        n_split = qmatmul_plan(m, w.n, w.k, *_fwd_card(x.device.index or 0, w.kind)).n_split
        if n_split > 1:
            part = torch.empty((n_split, m, w.n), dtype=torch.float32, device=x.device)
    status = build.library().zgml_qmatmul(
        KIND_CODE[w.kind], x.data_ptr(), w.qs.data_ptr(), w.d.data_ptr(), y.data_ptr(),
        None if part is None else part.data_ptr(), m, w.n, w.k, n_split,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "qmatmul")
    global_profile.count_op(counter("qmatmul", w.kind), "cuda")
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


def _i8_scratch(m: int, k: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """xq int8 [m, k] and xs f32 [m, k/32] for the pre-pass."""
    return (torch.empty((m, k), dtype=torch.int8, device=device),
            torch.empty((m, k // QK), dtype=torch.float32, device=device))


def quantize_act_cuda(x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's activation pre-pass alone, on the card: x f32 [M, K] -> (xq, xs),
    bit-equal to quantize_act_ref (so a check can hold it to the plain one)."""
    _require(x2.is_cuda and x2.dtype == torch.float32 and x2.dim() == 2
             and x2.is_contiguous() and x2.shape[1] % QK == 0,
             f"x must be a contiguous float32 [M, K % 32 == 0] CUDA tensor, got "
             f"{x2.dtype} {tuple(x2.shape)} on {x2.device}")
    xq, xs = _i8_scratch(*x2.shape, x2.device)
    status = build.library().zgml_i8_quantize(
        x2.data_ptr(), xq.data_ptr(), xs.data_ptr(), x2.shape[0], x2.shape[1],
        torch.cuda.current_stream(x2.device).cuda_stream)
    build.check(status, "i8_quantize")
    return xq, xs


def qmatmul_i8_cuda(x: torch.Tensor, w: PackedWeight) -> torch.Tensor:
    """K1: x f32 [..., K] with at most 32 rows -> f32 [..., N]."""
    _check(x, w)
    lead = x.shape[:-1]
    m = x.numel() // w.k
    _require(m <= I8_MAX_ROWS, f"the int8 tier takes M <= {I8_MAX_ROWS} rows, got {m}")
    y = torch.empty((*lead, w.n), dtype=torch.float32, device=x.device)
    if m == 0:
        return y
    xq, xs = _i8_scratch(m, w.k, x.device)
    status = build.library().zgml_qmatmul_i8(
        KIND_CODE[w.kind], x.data_ptr(), xq.data_ptr(), xs.data_ptr(), w.qs.data_ptr(),
        w.d.data_ptr(), y.data_ptr(), m, w.n, w.k,
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
    argmax(qmatmul_i8_cuda(x, w)) (same per-row device code)."""
    _check(x, w)
    _require(x.numel() == w.k, f"the greedy head takes one row, got {tuple(x.shape)}")
    xq, xs = _i8_scratch(1, w.k, x.device)
    ws = torch.empty(2, dtype=torch.int64, device=x.device)     # zeroed by the pre-pass
    out = torch.empty(1, dtype=torch.int64, device=x.device)
    status = build.library().zgml_greedy(
        KIND_CODE[w.kind], x.data_ptr(), xq.data_ptr(), xs.data_ptr(), w.qs.data_ptr(),
        w.d.data_ptr(), ws.data_ptr(), out.data_ptr(), w.n, w.k,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "greedy")
    global_profile.count_op(counter("qmatmul_greedy", w.kind), "cuda")
    return out
