"""Op dispatch: a CUDA tensor goes to its kernel, a CPU tensor to the plain version.

Counterpart of zgml_tpu/ops/dispatch.py. Two decisions, kept apart:

  tier of an op, from the device of its tensors and nothing else:
    cuda  -> the hand-written kernel (ops/qmatmul.py, ops/attention.py,
             ops/ffn.py, ops/layerkernel.py); a kernel that cannot build or
             launch raises, it never falls back
    cpu   -> the plain torch version
    other -> NotImplementedError
  which kernel a projection takes, from the JAX package's rule
    (qmatmul.py:639,728): the int8-activation K1 when config.i8dot() and the
    call has M <= 32 rows, else the f32-dequant K2, each at the weight's
    kind (Q4_0 or Q8_0); K7's A phase from config.attn_i8a and the fused
    decode FFN (K6c or K6d) from config.ffn_i8a, each at the JAX package's
    padded width of the weight (config.padded_k; zgml_tpu/ops/dispatch.py
    95-139, layerkernel.py:776, ffn.py:524). The model picks the decode path
    (K7, K6, K5) and where the FFN fuses from config (models/llama.py).

``force_ref()`` is the one explicit way to run the plain versions on the card
(to compare the kernels with them). It keeps the path and swaps each kernel
for its plain version; the JAX package's force_ref instead turns its fused
kernels off, which changes the path. Every call is counted by tier in
runtime.profile.global_profile, under one name per kernel and kind
(qmatmul = K2, qmatmul_i8 = K1, qmatmul_greedy = K5, fused_ffn_norm = K6d,
fused_ffn_norm_i8 = K6c, fused_ffn = K6b, attn_block = K7 with the f32 A
phase and attn_block_i8 with the int8 one, at Q4_0; the same names with _q8
for K2q8, K1q8, K5q8, K6a and K7 at Q8_0; attention = K3, decode_attention =
K4): a kernel's count is added where it launches, a plain call's here.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

from zgml_tpu_torch import config
from zgml_tpu_torch.ops import attention, ffn, layerkernel, qmatmul as _qmm, refs
from zgml_tpu_torch.quant.packed import PackedWeight
from zgml_tpu_torch.runtime.profile import global_profile

_force_ref: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "zgml_tpu_torch_force_ref", default=False)


@contextlib.contextmanager
def force_ref():
    """Run the plain torch versions, also for CUDA tensors, inside this block."""
    tok = _force_ref.set(True)
    try:
        yield
    finally:
        _force_ref.reset(tok)


def _device_of(*tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}: one device per op")
    if dev.type not in ("cuda", "cpu"):
        raise NotImplementedError(
            f"zgml_tpu_torch runs on CUDA (kernels) or the CPU (plain torch), not {dev}")
    return dev


def _use_kernel(*tensors: torch.Tensor) -> bool:
    return _device_of(*tensors).type == "cuda" and not _force_ref.get()


def qmatmul(x: torch.Tensor, w: PackedWeight, tier_rows: int | None = None) -> torch.Tensor:
    """x f32 [..., K] @ dequant(W).T -> f32 [..., N]. The tier follows the
    call's row count, or `tier_rows` when the caller computes a few rows of a
    larger call (the prefill head: one row of a chunk, as JAX computes the
    whole chunk)."""
    rows = x.numel() // w.k if tier_rows is None else tier_rows
    if config.i8dot() and rows <= _qmm.I8_MAX_ROWS:
        if _use_kernel(x, w.qs, w.d):
            return _qmm.qmatmul_i8_cuda(x, w)
        global_profile.count_op(_qmm.counter("qmatmul_i8", w.kind), "ref")
        return _qmm.qmatmul_i8_ref(x, w)
    if _use_kernel(x, w.qs, w.d):
        return _qmm.qmatmul_cuda(x, w)
    global_profile.count_op(_qmm.counter("qmatmul", w.kind), "ref")
    return _qmm.qmatmul_ref(x, w)


def qmatmul_greedy(x: torch.Tensor, w: PackedWeight) -> torch.Tensor | None:
    """argmax_n(x @ dequant(W)) of one row as int64 [1] through K5 (either
    kind, as `qmatmul_greedy_pallas`), or None where K5 does not apply (int8
    tier off, or more than one row): the caller then takes the argmax of
    qmatmul's logits, as zgml_tpu/ops/dispatch.py:80-92."""
    if not config.i8dot() or x.numel() != w.k:
        return None
    if _use_kernel(x, w.qs, w.d):
        return _qmm.greedy_cuda(x, w)
    global_profile.count_op(_qmm.counter("qmatmul_greedy", w.kind), "ref")
    return _qmm.greedy_ref(x, w)


def fused_ffn_norm(x: torch.Tensor, gamma: torch.Tensor, gu: PackedWeight, wd: PackedWeight,
                   eps: float) -> torch.Tensor:
    """x + down(silu(gate(n)) * up(n)), n = rmsnorm(x) * gamma; at most 32
    rows: K6a at Q8_0; at Q4_0 K6c where config.ffn_i8a holds at the padded
    width (as `fused_ffn_norm_q4n`, zgml_tpu/ops/ffn.py:524), else K6d."""
    a_i8 = gu.kind == "q4_0" and config.ffn_i8a(config.padded_k(gu.k, gu.kind))
    if _use_kernel(x, gamma, gu.qs, wd.qs):
        return ffn.fused_ffn_norm_cuda(x, gamma, gu, wd, eps, a_i8)
    name = "fused_ffn_norm_i8" if a_i8 else "fused_ffn_norm"
    global_profile.count_op(_qmm.counter(name, gu.kind), "ref")
    return ffn.fused_ffn_norm_ref(x, gamma, gu, wd, eps, a_i8)


def fused_ffn(h: torch.Tensor, gu: PackedWeight, wd: PackedWeight) -> torch.Tensor:
    """K6b: down(silu(gate(h)) * up(h)) for an already-normed h of at most 32
    rows, Q4_0 (zgml_tpu/ops/dispatch.py:95-110, counter fused_ffn)."""
    if _use_kernel(h, gu.qs, wd.qs):
        return ffn.fused_ffn_cuda(h, gu, wd)
    global_profile.count_op("fused_ffn", "ref")
    return ffn.fused_ffn_ref(h, gu, wd)


def attn_block(x, gamma, wqkv: PackedWeight, wo: PackedWeight, ck, cv, li: int, pos,
               cos, sin, n_heads: int, n_kv_heads: int, eps: float):
    """K7: one batch-1 decode token's attention half-layer over layer li of
    the stacked cache (written in place at pos); returns (x_out, k_cur,
    v_cur). Its A phase is int8 where config.attn_i8a holds at wqkv's
    padded width (layerkernel.py:776). See ops/layerkernel.py for layouts."""
    a_i8 = config.attn_i8a(config.padded_k(wqkv.k, wqkv.kind))
    if _use_kernel(x, gamma, wqkv.qs, wo.qs, ck, cv):
        return layerkernel.attn_block_cuda(x, gamma, wqkv, wo, ck, cv, li, pos, cos, sin,
                                           n_heads, n_kv_heads, eps, a_i8)
    name = "attn_block_i8" if a_i8 else "attn_block"
    global_profile.count_op(_qmm.counter(name, wqkv.kind), "ref")
    return layerkernel.attn_block_ref(x, gamma, wqkv, wo, ck, cv, li, pos, cos, sin,
                                      n_heads, n_kv_heads, eps, a_i8)


def flash_attention(q, k, v, kv_len=None, q_offset: int = 0, kv_row: int = 0):
    """Causal GQA prefill attention; see ops/attention.py for layouts."""
    if _use_kernel(q, k, v):
        return attention.flash_attention_cuda(q, k, v, kv_len, q_offset, kv_row)
    global_profile.count_op("attention", "ref")
    return attention.flash_attention_ref(q, k, v, kv_len, q_offset, kv_row)


def decode_attention(q, k, v, kv_len, kv_row: int = 0):
    """Single-token GQA attention over the cache prefix kv_len ([B] or int)."""
    if _use_kernel(q, k, v):
        return attention.decode_attention_cuda(q, k, v, kv_len, kv_row)
    global_profile.count_op("decode_attention", "ref")
    return attention.decode_attention_ref(q, k, v, kv_len, kv_row)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    # plain torch by design on both devices, as the JAX package leaves it to XLA
    _device_of(x, gamma)
    global_profile.count_op("rmsnorm", "torch")
    return refs.rmsnorm(x, gamma, eps)


def rope_apply(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    _device_of(x, cos, sin)
    global_profile.count_op("rope", "torch")
    return refs.rope_apply(x, cos, sin)
