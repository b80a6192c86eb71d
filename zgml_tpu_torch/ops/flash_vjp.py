"""K10: training's flash attention, its forward with the per-row LSE and its
FlashAttention-2 backward, kernels and plain versions, and the autograd
Function that joins them.

Counterpart of zgml_tpu/ops/flash_vjp.py: `_fwd_kernel` (K10f), `_dq_kernel`
(K10dq), `_dkv_kernel` (K10dkv) and `make_flash_vjp`, with f32 operands
(the JAX package's ZGML_TPU_PREFILL_BF16=0) or, bf16=True, its bf16=True
forms (the flag's default; config.prefill_bf16()):

  q, dO, O  f32  [B, Hq, Tq, d]
  k, v      bf16 [B, Hkv, S, d]    query head h reads KV head h // (Hq / Hkv);
                                   batch row b of q reads row b of k / v (the
                                   backward takes no kv_row, as JAX's assumes
                                   0, attention.py:214-215)
  lse       f32  [B, Hq, Tq]       m + log(l) per row, +inf where no key is live
  dk, dv    bf16 [B, Hq, S, d]     per QUERY head, in k's dtype

  p   = exp(s - lse), s = (q . k) / sqrt(d) masked as the forward masks it
  dV  = P^T dO
  dK  = dS'^T q / sqrt(d),  dS' = p * (bf16(dO) . v - rowsum(dO * O))
  dQ  = dS k / sqrt(d),     dS  = p * (dO . v - rowsum(dO * O))

dK's dP takes dO rounded to bf16 and dQ's the f32 dO, as the JAX kernels do
(flash_vjp.py:275 rounds it whatever the operand dtype, :182-185 does not).
The bf16 form (flash_vjp.py:60-84, 168-187, 258-284): K10f is K3's bf16
form with its LSE (ops/attention.py); the backward's s takes bf16(q), both
dP take bf16(dO), dV = bf16(p)^T bf16(dO), and dS k / dS'^T q keep the f32
dS against k and bf16(q). Its launches count under flash_fwd_bf16,
flash_dq_bf16 and flash_dkv_bf16. K10f alone also takes f32 k / v (a ring
hop under ZGML_TPU_PREFILL_BF16=0, parallel/ring.py, as JAX's hop attends
over the f32 K/V of the cp body): its f32-K/V form, flash_fwd_f32kv.
``FlashAttention`` sums each GQA group of dK / dV outside the kernels in f32
and rounds once to bf16, as XLA sums the bf16 group (flash_vjp.py:366-370).

``*_cuda`` launch csrc/flash_attn.cu (K10f, K3 with an LSE output: the same
launch and split plan, so its O is K3's bit for bit; with a split prefix
the combine pass writes the LSE) and csrc/flash_bwd.cu (K10dq, K10dkv and
their delta pre-pass, ``flash_delta_cuda``, run once per backward and
handed to both); ``*_ref`` are the plain torch versions. Callers go
through ``ops.dispatch.flash_attention``, which takes this path when grad
is enabled and q, k or v requires it.

K10dq tiles as K3 (64 packed query rows) with K/V tiles of DQ_BN keys and
splits each tile's keys by K3's rule (``attention.flash_split_plan`` at
K10dq's tile and occupancy). K10dkv takes 64 keys a block and streams
32-row query tiles; ``flash_dkv_split_plan`` splits each key tile's query
range across blocks where the key tiles alone do not fill the card. The
splits' f32 partials are added in split order: the same bits on every run.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from zgml_tpu_torch.ops import build, refs
from zgml_tpu_torch.ops.attention import (FlashPlan, _sm_count, check_qkv, counter,
                                          flash_attention_ref, flash_group, flash_split_plan,
                                          grouped_softmax_pv, launch_flash, normalised)
from zgml_tpu_torch.runtime.profile import global_profile

# K10dq's key tile (csrc/flash_bwd.cu DQ_BN); K10dkv's tiling (DKV_BK,
# DKV_BQ) and its split policy, as the prefill kernel's: fill one wave of
# the blocks the card holds, give each split at least DKV_MIN_Q_TILES query
# tiles, at most DKV_MAX_SPLIT splits
DQ_BN = 64
DKV_BK, DKV_BQ = 64, 32
DKV_MIN_Q_TILES = 2
DKV_MAX_SPLIT = 16


def _scores(q, k, kv_len, q_offset, bf16: bool = False, scale: float | None = None):
    """(s f32 [B, Hkv, n_rep, Tq, S] scaled by `scale` (1/sqrt(d) where
    None), its causal mask [Tq, S], q grouped [B, Hkv, n_rep, Tq, d],
    rounded to bf16 with bf16)."""
    b, hq, tq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    qg = q.to(torch.float32).reshape(b, hkv, hq // hkv, tq, d)
    if bf16:
        qg = refs.bf16_round(qg)
    sc = torch.einsum("bgrqd,bgkd->bgrqk", qg, k.to(torch.float32)) * (scale or 1.0 / d ** 0.5)
    ki = torch.arange(s, device=q.device)[None, :]
    qi = torch.arange(tq, device=q.device)[:, None] + q_offset
    return sc, (ki < (s if kv_len is None else kv_len)) & (ki <= qi), qg


def _probs(q, k, lse, kv_len, q_offset, bf16: bool = False, scale: float | None = None):
    """p = exp(s - lse) [B, Hkv, n_rep, Tq, S] (0 where masked), q grouped."""
    sc, mask, qg = _scores(q, k, kv_len, q_offset, bf16, scale)
    p = torch.where(mask, torch.exp(sc - lse.reshape(*qg.shape[:-1], 1)), torch.zeros_like(sc))
    return p, qg


def flash_fwd_lse_ref(q, k, v, kv_len=None, q_offset: int = 0, bf16: bool = False,
                      group: int | None = None, scale: float | None = None):
    """K10f's plain version: (o f32 [B, Hq, Tq, d], lse f32 [B, Hq, Tq]).
    bf16: K3's bf16 form (group and scale as flash_attention_ref's) and its
    lse = m + log(l), l the running sum of the unrounded p
    (flash_vjp.py:89-92)."""
    if bf16:
        sc, mask, _ = _scores(q, k, kv_len, q_offset, bf16=True, scale=scale)
        sc = torch.where(mask, sc, torch.full_like(sc, float("-inf")))
        o, m, l = grouped_softmax_pv(sc, v[:, :, None], None,
                                     group or flash_group(k.shape[2], False))
        lse = torch.where(l > 0, m + torch.log(torch.where(l > 0, l, torch.ones_like(l))),
                          torch.full_like(l, float("inf")))
        return normalised(o, l).reshape(q.shape), lse.reshape(q.shape[:3])
    sc, mask, _ = _scores(q, k, kv_len, q_offset)
    lse = torch.logsumexp(sc.masked_fill(~mask, float("-inf")), dim=-1)
    lse = torch.where(torch.isfinite(lse), lse, torch.full_like(lse, float("inf")))
    return flash_attention_ref(q, k, v, kv_len, q_offset), lse.reshape(q.shape[:3])


def _delta(do, o):
    return torch.sum(do.to(torch.float32) * o.to(torch.float32), dim=-1, keepdim=True)


def flash_dq_ref(q, k, v, do, o, lse, kv_len=None, q_offset: int = 0, bf16: bool = False):
    """K10dq's plain version: dq f32 [B, Hq, Tq, d]; bf16: s from bf16(q),
    dP from bf16(dO) (flash_vjp.py:168-187)."""
    b, hq, tq, d = q.shape
    hkv = k.shape[1]
    p, _ = _probs(q, k, lse, kv_len, q_offset, bf16)
    dog = do.to(torch.float32).reshape(b, hkv, hq // hkv, tq, d)
    dp = torch.einsum("bgrqd,bgkd->bgrqk", refs.bf16_round(dog) if bf16 else dog,
                      v.to(torch.float32))
    ds = p * (dp - _delta(dog, o.reshape(dog.shape))) * (1.0 / d ** 0.5)
    return torch.einsum("bgrqk,bgkd->bgrqd", ds, k.to(torch.float32)).reshape(b, hq, tq, d)


def flash_dkv_ref(q, k, v, do, o, lse, kv_len=None, q_offset: int = 0, bf16: bool = False,
                  scale: float | None = None):
    """K10dkv's plain version: (dk, dv) per query head [B, Hq, S, d] in k's
    and v's dtype; bf16: s from bf16(q), dV = bf16(p)^T bf16(dO), dK
    against bf16(q) (flash_vjp.py:258-284). `scale` scales the recomputed
    scores only (1/sqrt(d) where None; a check moves it by a few ulps to see
    which bf16(p) flip)."""
    b, hq, tq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    p, qg = _probs(q, k, lse, kv_len, q_offset, bf16, scale)
    dog = do.to(torch.float32).reshape(b, hkv, hq // hkv, tq, d)
    if bf16:
        dv = torch.einsum("bgrqk,bgrqd->bgrkd", refs.bf16_round(p), refs.bf16_round(dog))
    else:
        dv = torch.einsum("bgrqk,bgrqd->bgrkd", p, dog)
    dp = torch.einsum("bgrqd,bgkd->bgrqk", dog.to(torch.bfloat16).to(torch.float32),
                      v.to(torch.float32))
    ds = p * (dp - _delta(dog, o.reshape(dog.shape))) * (1.0 / d ** 0.5)
    dk = torch.einsum("bgrqk,bgrqd->bgrkd", ds, qg)
    return dk.reshape(b, hq, s, d).to(k.dtype), dv.reshape(b, hq, s, d).to(v.dtype)


def group_sum(dh: torch.Tensor, hkv: int) -> torch.Tensor:
    """dK or dV per query head [B, Hq, S, d] -> per KV head [B, Hkv, S, d]:
    each group of Hq / Hkv adjacent heads summed in f32 and rounded once to
    dh's dtype (what XLA does with the JAX package's bf16 sum)."""
    b, hq, s, d = dh.shape
    return dh.reshape(b, hkv, hq // hkv, s, d).to(torch.float32).sum(dim=2).to(dh.dtype)


def _check(name, q, k, v, extra=(), kv_dtype=torch.bfloat16):
    check_qkv(name, q, k, v, 0, None, kv_dtype=kv_dtype)
    if k.shape[0] != q.shape[0]:
        raise ValueError(f"{name}: k has {k.shape[0]} batch rows, q {q.shape[0]}: the training "
                         f"kernels read row b of k for row b of q (no kv_row)")
    b, hq, tq, _ = q.shape
    for t_ in extra:
        shape = q.shape if t_.dim() == 4 else (b, hq, tq)
        if (t_.device != q.device or t_.dtype != torch.float32 or t_.shape != shape
                or not t_.is_contiguous()):
            raise ValueError(f"{name}: dO, O, lse and delta must be contiguous float32 "
                             f"{tuple(q.shape)} / {(b, hq, tq)} on {q.device}")


def _lens(k, kv_len):
    return k.shape[2] if kv_len is None else int(kv_len)


@dataclasses.dataclass(frozen=True)
class FlashDkvPlan:
    """How K10dkv cuts one call: key tiles of ``bk`` keys, each walking the
    query tiles of ``bq`` rows from the first whose causal window reaches
    its lowest key, that range split over ``n_split`` blocks. The kernel
    does this arithmetic itself; these methods are the same formulas."""
    bk: int
    bq: int
    tq: int
    s: int
    kv_len: int
    q_offset: int
    n_split: int

    @property
    def n_kt(self) -> int:
        return -(-self.s // self.bk)

    def query_tiles(self, jt: int) -> tuple[int, int]:
        """(first query tile, count) of key tile jt; none past kv_len."""
        j0 = jt * self.bk
        first = max(0, j0 - self.q_offset) // self.bq
        if j0 >= min(self.kv_len, self.s):
            return first, 0
        return first, max(0, -(-self.tq // self.bq) - first)

    def split_queries(self, jt: int, z: int) -> tuple[int, int]:
        """Query rows [i0, i1) that split z of key tile jt takes."""
        first, n = self.query_tiles(jt)
        qt0, qt1 = first + z * n // self.n_split, first + (z + 1) * n // self.n_split
        return min(qt0 * self.bq, self.tq), min(qt1 * self.bq, self.tq)


def flash_dkv_split_plan(b: int, hq: int, tq: int, s: int, kv_len: int, q_offset: int,
                         sm_count: int, per_sm: int) -> FlashDkvPlan:
    """K10dkv's plan for q [b, hq, tq, d] over keys j < kv_len of s at
    q_offset on a card of sm_count SMs holding per_sm blocks each: split the
    query range into as many parts as one wave of blocks has room for beside
    the live key tiles, and no further than the longest key tile (the first)
    has query tiles for. A pure function of the shapes and the card."""
    kv_len = max(0, min(kv_len, s))
    live = b * hq * -(-kv_len // DKV_BK)
    longest = -(-tq // DKV_BQ) if kv_len > 0 else 0
    want = per_sm * sm_count // max(1, live)
    n_split = max(1, min(want, longest // DKV_MIN_Q_TILES, DKV_MAX_SPLIT))
    return FlashDkvPlan(DKV_BK, DKV_BQ, tq, s, kv_len, q_offset, n_split)


@functools.lru_cache(maxsize=None)
def _bwd_blocks_per_sm(index: int, d: int, which: int, bf16: bool = False) -> int:
    """Blocks of K10dq (which 0) or K10dkv (1) at head_dim d (bf16: its
    bf16 form) one SM of card `index` holds at once."""
    n = ctypes.c_int(0)
    with torch.cuda.device(index):
        build.check(build.library().zgml_flash_bwd_blocks_per_sm(d, which, int(bf16),
                                                                 ctypes.byref(n)),
                    "flash backward occupancy")
    if n.value < 1:
        raise RuntimeError(f"flash backward (head_dim {d}): no block fits on an SM")
    return n.value


def flash_dq_plan(q, k, kv_len, q_offset: int, bf16: bool = False) -> FlashPlan:
    """The plan K10dq takes for q and k on q's card: K3's row tiles and
    split rule at K10dq's key tile and occupancy."""
    b, hq, tq, d = q.shape
    _, hkv, s, _ = k.shape
    index = q.device.index or 0
    return flash_split_plan(b, hq, hkv, tq, d, min(_lens(k, kv_len), s), int(q_offset),
                            _sm_count(index), _bwd_blocks_per_sm(index, d, 0, bf16), bn=DQ_BN)


def flash_dkv_plan(q, k, kv_len, q_offset: int, bf16: bool = False) -> FlashDkvPlan:
    """The plan K10dkv takes for q and k on q's card."""
    b, hq, tq, d = q.shape
    s = k.shape[2]
    index = q.device.index or 0
    return flash_dkv_split_plan(b, hq, tq, s, _lens(k, kv_len), int(q_offset), _sm_count(index),
                                _bwd_blocks_per_sm(index, d, 1, bf16))


def fwd_counter(k: torch.Tensor, bf16: bool) -> str:
    """K10f's placement counter: flash_fwd_f32kv over f32 K/V (its f32-K/V
    form, a ring hop under ZGML_TPU_PREFILL_BF16=0), else flash_fwd or
    flash_fwd_bf16."""
    return "flash_fwd_f32kv" if k.dtype == torch.float32 else counter("flash_fwd", bf16)


def flash_fwd_lse_cuda(q, k, v, kv_len=None, q_offset: int = 0, bf16: bool = False,
                       group: int | None = None):
    """Launch K10f (csrc/flash_attn.cu): (o, lse); bf16 and group as
    attention.flash_attention_cuda's. Over f32 k / v (the JAX ring's hop at
    ZGML_TPU_PREFILL_BF16=0) its f32-K/V form, which has no bf16 form: JAX's
    bf16 kernel rounds K/V to bf16, so its caller hands them over rounded."""
    f32kv = k.dtype == torch.float32
    if f32kv and bf16:
        raise ValueError("flash_fwd: the bf16 form reads bf16 K/V, got float32")
    _check("flash_fwd", q, k, v, kv_dtype=torch.float32 if f32kv else torch.bfloat16)
    o, lse = launch_flash(q, k, None, v, None, kv_len, q_offset, 0, lse=True,
                          group=(group or flash_group(k.shape[2], False)) if bf16 else None)
    global_profile.count_op(fwd_counter(k, bf16), "cuda")
    return o, lse


def flash_delta_cuda(do, o):
    """The backward's pre-pass (csrc/flash_bwd.cu): delta = rowsum(dO * O)
    f32 [B, Hq, Tq], which K10dq and K10dkv both read."""
    b, hq, tq, d = do.shape
    delta = torch.empty((b, hq, tq), dtype=torch.float32, device=do.device)
    status = build.library().zgml_flash_delta(
        do.data_ptr(), o.data_ptr(), delta.data_ptr(), b * hq * tq, d,
        torch.cuda.current_stream(do.device).cuda_stream)
    build.check(status, "flash_delta")
    return delta


def flash_dq_cuda(q, k, v, do, o, lse, kv_len=None, q_offset: int = 0, delta=None,
                  bf16: bool = False):
    """Launch K10dq (csrc/flash_bwd.cu): dq f32 [B, Hq, Tq, d] (bf16: its
    bf16 form). `delta` from flash_delta_cuda(do, o), or None to run the
    pre-pass here."""
    _check("flash_dq", q, k, v, (do, o, lse) + (() if delta is None else (delta,)))
    b, hq, tq, d = q.shape
    _, hkv, s, _ = k.shape
    if delta is None:
        delta = flash_delta_cuda(do, o)
    plan = flash_dq_plan(q, k, kv_len, q_offset, bf16)
    dq = torch.empty_like(q)
    part = (torch.empty(plan.n_split * q.numel(), dtype=torch.float32, device=q.device)
            if plan.n_split > 1 else None)
    status = build.library().zgml_flash_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), None if part is None else part.data_ptr(), b, hq, hkv,
        tq, s, d, _lens(k, kv_len), int(q_offset), plan.n_split, plan.bn, int(bf16),
        1.0 / d ** 0.5, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(status, counter("flash_dq", bf16))
    global_profile.count_op(counter("flash_dq", bf16), "cuda")
    return dq


def flash_dkv_cuda(q, k, v, do, o, lse, kv_len=None, q_offset: int = 0, delta=None,
                   bf16: bool = False):
    """Launch K10dkv (csrc/flash_bwd.cu): (dk, dv) bf16 [B, Hq, S, d] per
    query head (bf16: its bf16 form). `delta` as flash_dq_cuda's."""
    _check("flash_dkv", q, k, v, (do, o, lse) + (() if delta is None else (delta,)))
    b, hq, tq, d = q.shape
    _, hkv, s, _ = k.shape
    if delta is None:
        delta = flash_delta_cuda(do, o)
    plan = flash_dkv_plan(q, k, kv_len, q_offset, bf16)
    dk = torch.empty((b, hq, s, d), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    part = (torch.empty(plan.n_split * 2 * dk.numel(), dtype=torch.float32, device=q.device)
            if plan.n_split > 1 else None)
    status = build.library().zgml_flash_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), None if part is None else part.data_ptr(),
        b, hq, hkv, tq, s, d, _lens(k, kv_len), int(q_offset), plan.n_split, int(bf16),
        1.0 / d ** 0.5, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(status, counter("flash_dkv", bf16))
    global_profile.count_op(counter("flash_dkv", bf16), "cuda")
    return dk, dv


class FlashAttention(torch.autograd.Function):
    """Causal GQA flash attention with the FlashAttention-2 backward: the
    counterpart of `make_flash_vjp`. ``apply(q, k, v, kv_len, q_offset,
    kernel, bf16, group)``: the kernels (K10f, then K10dq and K10dkv in
    backward) where `kernel` is true, else the plain versions, counted as
    "ref" placements; bf16 picks the bf16 forms in both directions (group:
    the forward's running-max step, as flash_attention_ref's); the tier is
    fixed at the forward call, so the backward recomputes p against the LSE
    of the same tier. Returns o f32 [B, Hq, Tq, d]."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, q_offset, kernel, bf16=False, group=None):
        if kernel:
            o, lse = flash_fwd_lse_cuda(q, k, v, kv_len, q_offset, bf16, group)
        else:
            global_profile.count_op(counter("flash_fwd", bf16), "ref")
            o, lse = flash_fwd_lse_ref(q, k, v, kv_len, q_offset, bf16, group)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.meta = (kv_len, q_offset, kernel, bf16)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        kv_len, q_offset, kernel, bf16 = ctx.meta
        do = do.to(torch.float32).contiguous()
        if kernel:
            delta = flash_delta_cuda(do, o)
            dq = flash_dq_cuda(q, k, v, do, o, lse, kv_len, q_offset, delta, bf16)
            dkh, dvh = flash_dkv_cuda(q, k, v, do, o, lse, kv_len, q_offset, delta, bf16)
        else:
            global_profile.count_op(counter("flash_dq", bf16), "ref")
            global_profile.count_op(counter("flash_dkv", bf16), "ref")
            dq = flash_dq_ref(q, k, v, do, o, lse, kv_len, q_offset, bf16)
            dkh, dvh = flash_dkv_ref(q, k, v, do, o, lse, kv_len, q_offset, bf16)
        hkv = k.shape[1]
        return dq, group_sum(dkh, hkv), group_sum(dvh, hkv), None, None, None, None, None
