"""K10: training's flash attention, its forward with the per-row LSE and its
FlashAttention-2 backward, kernels and plain versions, and the autograd
Function that joins them.

Counterpart of zgml_tpu/ops/flash_vjp.py: `_fwd_kernel` (K10f), `_dq_kernel`
(K10dq), `_dkv_kernel` (K10dkv) and `make_flash_vjp`, at the JAX package's
ZGML_TPU_PREFILL_BF16=0 (f32 operands, the port's standing prefill function;
ops/attention.py):

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
``FlashAttention`` sums each GQA group of dK / dV outside the kernels in f32
and rounds once to bf16, as XLA sums the bf16 group (flash_vjp.py:366-370).

``*_cuda`` launch csrc/flash_attn.cu (K10f, K3 with an LSE output: the same
launch and split plan, so its O is K3's bit for bit; with a split prefix
the combine pass writes the LSE) and csrc/flash_bwd.cu; ``*_ref`` are the
plain torch versions. Callers go through ``ops.dispatch.flash_attention``,
which takes this path when grad is enabled and q, k or v requires it.
"""
from __future__ import annotations

import torch

from zgml_tpu_torch.ops import build
from zgml_tpu_torch.ops.attention import check_qkv, flash_attention_ref, launch_flash
from zgml_tpu_torch.runtime.profile import global_profile


def _scores(q, k, kv_len, q_offset):
    """(s f32 [B, Hkv, n_rep, Tq, S], its causal mask [Tq, S], q grouped
    [B, Hkv, n_rep, Tq, d])."""
    b, hq, tq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    qg = q.to(torch.float32).reshape(b, hkv, hq // hkv, tq, d)
    sc = torch.einsum("bgrqd,bgkd->bgrqk", qg, k.to(torch.float32)) * (1.0 / d ** 0.5)
    ki = torch.arange(s, device=q.device)[None, :]
    qi = torch.arange(tq, device=q.device)[:, None] + q_offset
    return sc, (ki < (s if kv_len is None else kv_len)) & (ki <= qi), qg


def _probs(q, k, lse, kv_len, q_offset):
    """p = exp(s - lse) [B, Hkv, n_rep, Tq, S] (0 where masked), q grouped."""
    sc, mask, qg = _scores(q, k, kv_len, q_offset)
    p = torch.where(mask, torch.exp(sc - lse.reshape(*qg.shape[:-1], 1)), torch.zeros_like(sc))
    return p, qg


def flash_fwd_lse_ref(q, k, v, kv_len=None, q_offset: int = 0):
    """K10f's plain version: (o f32 [B, Hq, Tq, d], lse f32 [B, Hq, Tq])."""
    sc, mask, _ = _scores(q, k, kv_len, q_offset)
    lse = torch.logsumexp(sc.masked_fill(~mask, float("-inf")), dim=-1)
    lse = torch.where(torch.isfinite(lse), lse, torch.full_like(lse, float("inf")))
    return flash_attention_ref(q, k, v, kv_len, q_offset), lse.reshape(q.shape[:3])


def _delta(do, o):
    return torch.sum(do.to(torch.float32) * o.to(torch.float32), dim=-1, keepdim=True)


def flash_dq_ref(q, k, v, do, o, lse, kv_len=None, q_offset: int = 0):
    """K10dq's plain version: dq f32 [B, Hq, Tq, d]."""
    b, hq, tq, d = q.shape
    hkv = k.shape[1]
    p, _ = _probs(q, k, lse, kv_len, q_offset)
    dog = do.to(torch.float32).reshape(b, hkv, hq // hkv, tq, d)
    dp = torch.einsum("bgrqd,bgkd->bgrqk", dog, v.to(torch.float32))
    ds = p * (dp - _delta(dog, o.reshape(dog.shape))) * (1.0 / d ** 0.5)
    return torch.einsum("bgrqk,bgkd->bgrqd", ds, k.to(torch.float32)).reshape(b, hq, tq, d)


def flash_dkv_ref(q, k, v, do, o, lse, kv_len=None, q_offset: int = 0):
    """K10dkv's plain version: (dk, dv) per query head [B, Hq, S, d] in k's
    and v's dtype."""
    b, hq, tq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    p, qg = _probs(q, k, lse, kv_len, q_offset)
    dog = do.to(torch.float32).reshape(b, hkv, hq // hkv, tq, d)
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


def _check(name, q, k, v, extra=()):
    check_qkv(name, q, k, v, 0, None)
    if k.shape[0] != q.shape[0]:
        raise ValueError(f"{name}: k has {k.shape[0]} batch rows, q {q.shape[0]}: the training "
                         f"kernels read row b of k for row b of q (no kv_row)")
    b, hq, tq, _ = q.shape
    for t_ in extra:
        shape = q.shape if t_.dim() == 4 else (b, hq, tq)
        if (t_.device != q.device or t_.dtype != torch.float32 or t_.shape != shape
                or not t_.is_contiguous()):
            raise ValueError(f"{name}: dO, O and lse must be contiguous float32 {tuple(q.shape)} "
                             f"/ {(b, hq, tq)} on {q.device}")


def _lens(k, kv_len):
    return k.shape[2] if kv_len is None else int(kv_len)


def flash_fwd_lse_cuda(q, k, v, kv_len=None, q_offset: int = 0):
    """Launch K10f (csrc/flash_attn.cu): (o, lse)."""
    _check("flash_fwd", q, k, v)
    o, lse = launch_flash(q, k, None, v, None, kv_len, q_offset, 0, lse=True)
    global_profile.count_op("flash_fwd", "cuda")
    return o, lse


def flash_dq_cuda(q, k, v, do, o, lse, kv_len=None, q_offset: int = 0):
    """Launch K10dq (csrc/flash_bwd.cu): dq f32 [B, Hq, Tq, d]."""
    _check("flash_dq", q, k, v, (do, o, lse))
    b, hq, tq, d = q.shape
    _, hkv, s, _ = k.shape
    dq = torch.empty_like(q)
    status = build.library().zgml_flash_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), o.data_ptr(), lse.data_ptr(),
        dq.data_ptr(), b, hq, hkv, tq, s, d, _lens(k, kv_len), int(q_offset), 1.0 / d ** 0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(status, "flash_dq")
    global_profile.count_op("flash_dq", "cuda")
    return dq


def flash_dkv_cuda(q, k, v, do, o, lse, kv_len=None, q_offset: int = 0):
    """Launch K10dkv (csrc/flash_bwd.cu): (dk, dv) bf16 [B, Hq, S, d] per
    query head."""
    _check("flash_dkv", q, k, v, (do, o, lse))
    b, hq, tq, d = q.shape
    _, hkv, s, _ = k.shape
    dk = torch.empty((b, hq, s, d), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    status = build.library().zgml_flash_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), o.data_ptr(), lse.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, hq, hkv, tq, s, d, _lens(k, kv_len), int(q_offset),
        1.0 / d ** 0.5, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(status, "flash_dkv")
    global_profile.count_op("flash_dkv", "cuda")
    return dk, dv


class FlashAttention(torch.autograd.Function):
    """Causal GQA flash attention with the FlashAttention-2 backward: the
    counterpart of `make_flash_vjp`. ``apply(q, k, v, kv_len, q_offset,
    kernel)``: the kernels (K10f, then K10dq and K10dkv in backward) where
    `kernel` is true, else the plain versions, counted as "ref" placements;
    the tier is fixed at the forward call, so the backward recomputes p
    against the LSE of the same tier. Returns o f32 [B, Hq, Tq, d]."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, q_offset, kernel):
        if kernel:
            o, lse = flash_fwd_lse_cuda(q, k, v, kv_len, q_offset)
        else:
            global_profile.count_op("flash_fwd", "ref")
            o, lse = flash_fwd_lse_ref(q, k, v, kv_len, q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.meta = (kv_len, q_offset, kernel)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        kv_len, q_offset, kernel = ctx.meta
        do = do.to(torch.float32).contiguous()
        if kernel:
            dq = flash_dq_cuda(q, k, v, do, o, lse, kv_len, q_offset)
            dkh, dvh = flash_dkv_cuda(q, k, v, do, o, lse, kv_len, q_offset)
        else:
            global_profile.count_op("flash_dq", "ref")
            global_profile.count_op("flash_dkv", "ref")
            dq = flash_dq_ref(q, k, v, do, o, lse, kv_len, q_offset)
            dkh, dvh = flash_dkv_ref(q, k, v, do, o, lse, kv_len, q_offset)
        hkv = k.shape[1]
        return dq, group_sum(dkh, hkv), group_sum(dvh, hkv), None, None, None
