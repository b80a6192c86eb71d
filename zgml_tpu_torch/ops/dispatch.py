"""Op dispatch: a CUDA tensor goes to its kernel, a CPU tensor to the plain version.

Counterpart of zgml_tpu/ops/dispatch.py. Two decisions, kept apart:

  tier of an op, from the device of its tensors and nothing else:
    cuda  -> the hand-written kernel (ops/qmatmul.py, ops/attention.py,
             ops/ffn.py, ops/layerkernel.py, ops/flash_vjp.py, ops/rmsnorm.py,
             ops/elementwise.py, ops/stackkernel.py, ops/tapekernel.py); a
             kernel that cannot build or launch
             raises, it never falls back
    cpu   -> the plain torch version
    other -> NotImplementedError
  which kernel a projection takes, from the JAX package's rule
    (qmatmul.py:639,728): the int8-activation K1 when config.i8dot() and the
    call has M <= 32 rows, else the f32-dequant K2, each at the weight's
    kind (Q4_0 or Q8_0); a dense [K, N] weight takes torch.matmul, as the
    JAX package leaves it to XLA (dispatch.py:76-77); K7's A phase from
    config.attn_i8a and the fused decode FFN (K6c or K6d) from
    config.ffn_i8a, each at the JAX package's padded width of the weight
    (config.padded_k; zgml_tpu/ops/dispatch.py 95-139, layerkernel.py:776,
    ffn.py:524). The model picks the decode path (K7, K6, K5) and where the
    FFN fuses from config (models/llama.py).

Under autograd (grad enabled and an input that requires grad): projections
go through qmatmul.QMatmul (backward K11, dx = g @ dequant(W)), the fused
FFN of <= 32 rows (K6b, K6a's no-norm form) through ffn.FusedFFN (backward:
the projections' recompute at their tier and K11, as `_ffn_diff_bwd`), and
flash attention through flash_vjp.FlashAttention (K10f forward, K10dq and
K10dkv backward), on both tiers; K12 and K13 through rmsnorm.RMSNorm and
elementwise.FusedChain, whose backward recomputes the plain version, as the
JAX custom VJPs do. The other kernels have no backward (the JAX package has
none for them): called so, they raise NotImplementedError naming the
ROADMAP item, rather than hand back a result whose gradient would be
silently zero.

``force_ref()`` is the one explicit way to run the plain versions on the card
(to compare the kernels with them). It keeps the path and swaps each kernel
for its plain version, in a backward too: every autograd Function here takes
its backward's kernels as its forward decided them, since autograd runs a
CUDA backward on its own device thread, where force_ref()'s context variable
is not set; the JAX package's force_ref instead turns its fused
kernels off, which changes the path. The JAX per-op switches
(ZGML_TPU_KERNELS=ref, ZGML_TPU_KERNELS_DISABLE; config.kernel_on) do change
it, as they do in the JAX package: ``use_kernel(op)`` runs a kernel only
where its op is on and force_ref() is not in effect, and the path decisions
here and in the model read config.kernel_on (config.py lists each op's
path when it is off). Every call is counted by tier in
runtime.profile.global_profile, under one name per kernel and kind
(qmatmul = K2 and qmatmul_bf16 its bf16 form, qmatmul_i8 = K1,
qmatmul_greedy = K5 (qmatmul_greedy_ksplit on K1's K-split plan; the plain
version counts under qmatmul_greedy), fused_ffn_norm = K6d,
fused_ffn_norm_i8 = K6c, fused_ffn = K6b (fused_ffn_q8 = K6a's no-norm
form), attn_block_ffn = K7 with its phase E (ZGML_TPU_LAYER_FFN), attn_block = K7 with the f32 A
phase and attn_block_i8 with the int8 one, each + _kv8 over the int8 cache,
at Q4_0; the same names with _q8 for K2q8, K1q8, K5q8, K6a and K7 at Q8_0;
attention = K3 (attention_f32kv its form over f32 K / V), decode_attention =
K4 (decode_attention_f32 its f32 form over f32 K / V), flash_attention_q8 = K9 (each prefill
flash kernel + _bf16 in its bf16 form, ZGML_TPU_PREFILL_BF16),
decode_attention_q8 = K8 (decode_attention_q8_i8pv in its
ZGML_TPU_ATTN_I8PV mode), the JAX package's names; attn_block_f32kv (+_i8, _q8,
_ffn) K7 over the f32 cache; flash_fwd = K10f,
flash_dq = K10dq, flash_dkv = K10dkv and qmatmul_bwd = K11, with _q8 for
K11q8; matmul for a dense projection; rmsnorm = K12 under
ZGML_TPU_KERNELS_FORCE=rmsnorm, plain torch under `torch` otherwise;
fused_chain = K13, the graph tier's fused chains (f32; fused_chain_bf16,
fused_chain_f16 and fused_chain_i32 its other dtypes); stack_decode = K14 and
tape_decode = K15, tape_decode_f32 under ZGML_TPU_TAPE_BF16=0, the
whole-stack decode megacalls, each + _f32kv over the f32 cache; ring_attention, one call of parallel/ring.py,
whose hops count as K10f's): a kernel's count is
added where it launches, a plain call's here. The cache's dtype picks K3/K4
or K9/K8 in the model, and K7's cache mode here.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

from zgml_tpu_torch import config
from zgml_tpu_torch.ops import attention, ffn, flash_vjp, layerkernel, qmatmul as _qmm, refs
from zgml_tpu_torch.ops import elementwise as _chain, rmsnorm as _rmsnorm
from zgml_tpu_torch.ops import stackkernel, tapekernel
from zgml_tpu_torch.quant import kv_cache
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


def use_kernel(op: str | None = None) -> bool:
    """The port's use_pallas(op) (zgml_tpu/ops/dispatch.py:41-52): off under
    force_ref(), under ZGML_TPU_KERNELS=ref, and for an op that
    ZGML_TPU_KERNELS_DISABLE names (config.kernel_on); on otherwise. Where
    it is off a CUDA tensor runs the plain version, counted under `ref`."""
    return not _force_ref.get() and config.kernel_on(op)


def _use_kernel(op: str | None, *tensors: torch.Tensor) -> bool:
    return _device_of(*tensors).type == "cuda" and use_kernel(op)


def needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


# the ROADMAP item of the kernels that have no backward
NO_BACKWARD = "ROADMAP.md B.5"


def _refuse_grad(name: str, *tensors):
    """Raise where a kernel without a backward meets autograd."""
    if needs_grad(*tensors):
        raise NotImplementedError(
            f"{name} has no backward (nor has the JAX package's kernel; {NO_BACKWARD}); train "
            f"through LlamaModel.forward(tokens), which takes K1/K2, K6b/K6a, K11 and K10, or "
            f"run under torch.no_grad()")


def _kernel_or(kernel: bool | None, op: str, *tensors) -> bool:
    """`kernel` where the caller decided it, else _use_kernel(op, ...). A
    backward decides at forward time: autograd runs a CUDA backward on its
    own device thread, where force_ref()'s context variable is not set."""
    if kernel is None:
        return _use_kernel(op, *tensors)
    _device_of(*tensors)
    return kernel


def _qmatmul_fwd(x: torch.Tensor, w: PackedWeight, i8: bool, bf16: bool,
                 kernel: bool | None = None) -> torch.Tensor:
    kernel = _kernel_or(kernel, "qmatmul", x, w.qs, w.d)
    if i8:
        if kernel:
            return _qmm.qmatmul_i8_cuda(x, w)
        global_profile.count_op(_qmm.counter("qmatmul_i8", w.kind), "ref")
        return _qmm.qmatmul_i8_ref(x, w)
    if kernel:
        return _qmm.qmatmul_cuda(x, w, bf16)
    global_profile.count_op(_qmm.counter("qmatmul", w.kind, bf16), "ref")
    return _qmm.qmatmul_ref(x, w, bf16)


def qmatmul_bwd(g: torch.Tensor, w: PackedWeight, kernel: bool | None = None) -> torch.Tensor:
    """K11: dx = g @ dequant(W), g f32 [..., N] -> f32 [..., K]; `kernel`:
    whether to launch it, as the forward decided (None: decide here)."""
    if _kernel_or(kernel, "qmatmul", g, w.qs, w.d):
        return _qmm.qmatmul_bwd_cuda(g, w)
    global_profile.count_op(_qmm.counter("qmatmul_bwd", w.kind), "ref")
    return _qmm.qmatmul_bwd_ref(g, w)


def _tier(rows: int) -> tuple[bool, bool]:
    """(int8, bf16) of a projection standing for `rows` rows: K1 up to 32
    rows under config.i8dot() (JAX's bm == m_pad <= 32, m_pad = rows padded
    to a multiple of 8, qmatmul.py:719-729), else K2, in its bf16 form where
    qmatmul.bf16_tier holds; with qmatmul switched off, the f32 tier."""
    on = config.kernel_on("qmatmul")
    i8 = config.i8dot() and on and rows <= _qmm.I8_MAX_ROWS
    return i8, on and _qmm.bf16_tier(rows, i8)


def qmatmul(x: torch.Tensor, w, tier_rows: int | None = None) -> torch.Tensor:
    """x f32 [..., K] @ dequant(W).T -> f32 [..., N] for a PackedWeight W,
    x @ w for a dense [K, N] tensor. The tier follows the call's row count,
    or `tier_rows` when the caller computes a few rows of a larger call (the
    prefill head: one row of a chunk, as JAX computes the whole chunk): K1
    up to 32 rows under config.i8dot(), else K2, in its bf16 form where
    qmatmul.bf16_tier says JAX's dot_bf16 holds; with qmatmul switched off,
    the f32 tier at every M (dispatch.py:67-75)."""
    if isinstance(w, torch.Tensor):
        _device_of(x, w)
        global_profile.count_op("matmul", "torch")
        return torch.matmul(x, w)
    rows = x.numel() // w.k if tier_rows is None else tier_rows
    i8, bf16 = _tier(rows)
    if needs_grad(x):
        kernel = _use_kernel("qmatmul", x, w.qs, w.d)    # for the backward too (_kernel_or)
        return _qmm.QMatmul.apply(x, w, lambda x_, w_: _qmatmul_fwd(x_, w_, i8, bf16, kernel),
                                  lambda g_, w_: qmatmul_bwd(g_, w_, kernel))
    return _qmatmul_fwd(x, w, i8, bf16)


def qmatmul_greedy(x: torch.Tensor, w: PackedWeight) -> torch.Tensor | None:
    """argmax_n(x @ dequant(W)) of one row as int64 [1] through K5 (either
    kind, as `qmatmul_greedy_pallas`), or None where K5 does not apply (int8
    tier or qmatmul off, or more than one row): the caller then takes the
    argmax of qmatmul's logits, as zgml_tpu/ops/dispatch.py:80-92."""
    if not config.i8dot() or not config.kernel_on("qmatmul") or x.numel() != w.k:
        return None
    _refuse_grad("qmatmul_greedy (K5)", x)
    if _use_kernel("qmatmul", x, w.qs, w.d):
        return _qmm.greedy_cuda(x, w)
    global_profile.count_op(_qmm.counter("qmatmul_greedy", w.kind), "ref")
    return _qmm.greedy_ref(x, w)


def fused_ffn_norm(x: torch.Tensor, gamma: torch.Tensor, gu: PackedWeight, wd: PackedWeight,
                   eps: float) -> torch.Tensor:
    """x + down(silu(gate(n)) * up(n)), n = rmsnorm(x) * gamma; at most 32
    rows: K6a at Q8_0; at Q4_0 K6c where config.ffn_i8a holds at the padded
    width (as `fused_ffn_norm_q4n`, zgml_tpu/ops/ffn.py:524), else K6d."""
    _refuse_grad("fused_ffn_norm (K6a / K6c / K6d)", x, gamma)
    a_i8 = gu.kind == "q4_0" and config.ffn_i8a(config.padded_k(gu.k, gu.kind))
    if _use_kernel("fused_ffn", x, gamma, gu.qs, wd.qs):
        return ffn.fused_ffn_norm_cuda(x, gamma, gu, wd, eps, a_i8)
    name = "fused_ffn_norm_i8" if a_i8 else "fused_ffn_norm"
    global_profile.count_op(_qmm.counter(name, gu.kind), "ref")
    return ffn.fused_ffn_norm_ref(x, gamma, gu, wd, eps, a_i8)


def fused_ffn(h: torch.Tensor, gu: PackedWeight, wd: PackedWeight) -> torch.Tensor:
    """down(silu(gate(h)) * up(h)) for an already-normed h of at most 32
    rows (zgml_tpu/ops/dispatch.py:95-110): K6b at Q4_0 (counter fused_ffn),
    K6a's no-norm form at Q8_0 (fused_ffn_q8). Under autograd through
    ffn.FusedFFN, whose backward recomputes gate|up at the projection tier
    of these rows and takes K11 twice (`_ffn_diff_bwd`)."""
    kernel = _use_kernel("fused_ffn", h, gu.qs, wd.qs)

    def fwd(h_):
        if kernel:
            return ffn.fused_ffn_cuda(h_, gu, wd)
        global_profile.count_op(_qmm.counter("fused_ffn", gu.kind), "ref")
        return ffn.fused_ffn_ref(h_, gu, wd)

    if needs_grad(h):
        # the backward's tiers decided now (_kernel_or): K1 / K2 and K11, or
        # their plain versions under force_ref() or with qmatmul switched off
        i8, bf16 = _tier(h.numel() // gu.k)
        proj = _use_kernel("qmatmul", h, gu.qs, gu.d)
        return ffn.FusedFFN.apply(h, gu, wd, fwd,
                                  lambda x_, w_: _qmatmul_fwd(x_, w_, i8, bf16, proj),
                                  lambda g_, w_: qmatmul_bwd(g_, w_, proj))
    return fwd(h)


def attn_block(x, gamma, wqkv: PackedWeight, wo: PackedWeight, ck, cv, li: int, pos,
               cos, sin, n_heads: int, n_kv_heads: int, eps: float, ffn=None):
    """K7: one batch-1 decode token's attention half-layer over layer li of
    the stacked cache (written in place at pos); returns (x_out, k_cur,
    v_cur). Its A phase is int8 where config.attn_i8a holds at wqkv's
    padded width (layerkernel.py:776), its phase B over the int8 cache where
    ck / cv are (levels, scales) tuples (layerkernel.py:799). With ffn =
    (ffn_norm, w_gate_up, w_down) its phase E (JAX's has_ffn, the caller's
    choice under ZGML_TPU_LAYER_FFN) runs the layer's FFN, K6d's f32
    function, in the same launch: x_out is then the whole layer's output
    (counter attn_block_ffn, +_i8 / _kv8 by mode). See ops/layerkernel.py for
    layouts."""
    _refuse_grad("attn_block (K7)", x, gamma, cos, sin)
    a_i8 = config.attn_i8a(config.padded_k(wqkv.k, wqkv.kind))
    cache = (*ck, *cv) if isinstance(ck, tuple) else (ck, cv)
    if _use_kernel("attn_block", x, gamma, wqkv.qs, wo.qs, *cache):
        return layerkernel.attn_block_cuda(x, gamma, wqkv, wo, ck, cv, li, pos, cos, sin,
                                           n_heads, n_kv_heads, eps, a_i8, ffn=ffn)
    global_profile.count_op(layerkernel.counter_name(a_i8, layerkernel.cache_form(ck),
                                                     wqkv.kind, ffn is not None), "ref")
    if ffn is not None:
        return layerkernel.attn_block_ffn_ref(x, gamma, wqkv, wo, ck, cv, li, pos, cos, sin,
                                              n_heads, n_kv_heads, eps, ffn, a_i8)
    return layerkernel.attn_block_ref(x, gamma, wqkv, wo, ck, cv, li, pos, cos, sin,
                                      n_heads, n_kv_heads, eps, a_i8)


def flash_attention(q, k, v, kv_len=None, q_offset: int = 0, kv_row: int = 0,
                    tile_s: int | None = None):
    """Causal GQA prefill attention; see ops/attention.py for layouts. Under
    autograd flash_vjp.FlashAttention (K10), which reads row b of k / v for
    row b of q: a kv_row other than 0 raises, as the JAX backward assumes 0
    (attention.py:214-215). With attention switched off, the plain version,
    differentiated by autograd as the JAX ref tier is by jax.grad
    (dispatch.py:173-190), not K10's backward (its dK takes a bf16 dO), in
    f32 at every ZGML_TPU_PREFILL_BF16. With it on, the bf16 forms where
    config.prefill_bf16(), their running max stepping as JAX's tile over a
    cache of tile_s positions (k's length where None: training passes the
    cache length the JAX forward attends over). Over f32 K / V (the f32
    cache) both forms read them as JAX's kernel casts them (the bf16 form
    their bf16 roundings), counted under attention(_bf16)_f32kv."""
    on = config.kernel_on("attention")
    bf16 = on and config.prefill_bf16()
    group = attention.flash_group(tile_s or k.shape[2], False) if bf16 else None
    if needs_grad(q, k, v) and on:
        if kv_row != 0:
            raise NotImplementedError(
                f"flash attention under autograd with kv_row={kv_row}: the backward reads "
                f"k / v rows from 0, as the JAX package's ({NO_BACKWARD})")
        return flash_vjp.FlashAttention.apply(q, k, v, kv_len, q_offset,
                                              _use_kernel("attention", q, k, v), bf16, group)
    if _use_kernel("attention", q, k, v):
        return attention.flash_attention_cuda(q, k, v, kv_len, q_offset, kv_row, bf16, group)
    global_profile.count_op(attention.flash_counter(k, bf16), "ref")
    return attention.flash_attention_ref(q, k, v, kv_len, q_offset, kv_row, bf16, group)


def flash_fwd_lse(q, k, v, kv_len=None, q_offset: int = 0, bf16: bool = False,
                  group: int | None = None):
    """K10f outside autograd, (o f32 [B, Hq, Tq, d], lse f32 [B, Hq, Tq]):
    one ring-attention hop (parallel/ring.py, the JAX ring's direct
    `_flash_fwd` call, ring.py:56-66). bf16 and group as flash_attention's;
    over f32 k / v (bf16 False) K10f's f32-K/V form, counted flash_fwd_f32kv.
    The ring decides its tier from the ring_attention switch, so this runs
    the kernel on the card unless under force_ref()."""
    _refuse_grad("flash_fwd_lse (K10f)", q, k, v)
    if _use_kernel(None, q, k, v):
        return flash_vjp.flash_fwd_lse_cuda(q, k, v, kv_len, q_offset, bf16, group)
    global_profile.count_op(flash_vjp.fwd_counter(k, bf16), "ref")
    return flash_vjp.flash_fwd_lse_ref(q, k, v, kv_len, q_offset, bf16, group)


def decode_attention(q, k, v, kv_len, kv_row: int = 0):
    """Single-token GQA attention over the cache prefix kv_len ([B] or int):
    K4 over a bf16 cache, its f32 form over f32 K / V (the JAX kernel widens
    any cache, attention.py:306-307), counted under decode_attention_f32."""
    _refuse_grad("decode_attention (K4)", q, k, v)
    if _use_kernel("decode_attention", q, k, v):
        return attention.decode_attention_cuda(q, k, v, kv_len, kv_row)
    global_profile.count_op(attention.decode_counter(k), "ref")
    return attention.decode_attention_ref(q, k, v, kv_len, kv_row)


def flash_attention_q8(q, k, ks, v, vs, kv_len=None, q_offset: int = 0, kv_row: int = 0):
    """K9: causal GQA prefill attention over the int8 cache (levels k, v,
    per-position scales ks, vs); zgml_tpu/ops/dispatch.py:191-206. With
    attention switched off, JAX's path: the rows dequantized to f32, then the
    plain prefill attention."""
    _refuse_grad("flash_attention_q8 (K9)", q, ks, vs)
    if not config.kernel_on("attention"):
        _device_of(q, k, ks, v, vs)
        global_profile.count_op("flash_attention_q8", "ref")
        kf, vf = _dequantized_rows(q.shape[0], kv_row, k, ks, v, vs)
        return attention.flash_attention_ref(q, kf, vf, kv_len, q_offset)
    bf16 = config.prefill_bf16()
    if _use_kernel("attention", q, k, ks, v, vs):
        return attention.flash_attention_q8_cuda(q, k, ks, v, vs, kv_len, q_offset, kv_row,
                                                 bf16)
    global_profile.count_op(attention.counter("flash_attention_q8", bf16), "ref")
    return attention.flash_attention_q8_ref(q, k, ks, v, vs, kv_len, q_offset, kv_row, bf16)


def decode_attention_q8(q, k, ks, v, vs, kv_len, kv_row: int = 0):
    """K8: one query token per row over the int8 cache prefix kv_len ([B] or
    int); zgml_tpu/ops/dispatch.py:209-220. Under ZGML_TPU_ATTN_I8PV=1
    (config.attn_i8pv(), read per call) its int8 P.V mode, counted under
    decode_attention_q8_i8pv. With decode_attention switched off, JAX's path:
    the rows dequantized to f32 and attended with the unquantized q (another
    function than K8's, in either mode)."""
    _refuse_grad("decode_attention_q8 (K8)", q, ks, vs)
    if not config.kernel_on("decode_attention"):
        _device_of(q, k, ks, v, vs)
        global_profile.count_op("decode_attention_q8", "ref")
        kf, vf = _dequantized_rows(q.shape[0], kv_row, k, ks, v, vs)
        return attention.decode_attention_ref(q, kf, vf, kv_len)
    i8pv = config.attn_i8pv()
    if _use_kernel("decode_attention", q, k, ks, v, vs):
        return attention.decode_attention_q8_cuda(q, k, ks, v, vs, kv_len, kv_row, i8pv)
    global_profile.count_op(attention.q8_counter(i8pv), "ref")
    return attention.decode_attention_q8_ref(q, k, ks, v, vs, kv_len, kv_row, i8pv)


def _dequantized_rows(b: int, kv_row: int, k, ks, v, vs):
    """Rows kv_row .. kv_row + b of the int8 cache as f32 K and V (the JAX
    ref tier's dequantize_cache)."""
    rows = slice(kv_row, kv_row + b)
    return kv_cache.dequantize(k[rows], ks[rows]), kv_cache.dequantize(v[rows], vs[rows])


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Plain torch by default on both devices, as the JAX package leaves the
    norm to XLA (counted under the `torch` tier). Where
    ZGML_TPU_KERNELS_FORCE names "rmsnorm" and the switches leave it on
    (zgml_tpu/ops/dispatch.py:144-155): K12 on the card, through
    rmsnorm.RMSNorm under autograd; its plain version on the CPU and under
    force_ref(), counted under `ref`."""
    dev = _device_of(x, gamma)
    if "rmsnorm" not in config.kernels_forced() or not config.kernel_on("rmsnorm"):
        global_profile.count_op("rmsnorm", "torch")
        return refs.rmsnorm(x, gamma, eps)
    kernel = dev.type == "cuda" and use_kernel("rmsnorm")
    if needs_grad(x, gamma):
        return _rmsnorm.RMSNorm.apply(x, gamma, eps, kernel)
    if kernel:
        return _rmsnorm.rmsnorm_cuda(x, gamma, eps)
    global_profile.count_op("rmsnorm", "ref")
    return _rmsnorm.rmsnorm_ref(x, gamma, eps)


def fused_chain(x: torch.Tensor, steps, sides) -> torch.Tensor:
    """K13, the graph tier's fused elementwise chain (ops/elementwise.py):
    the kernel on the card, the plain composition on the CPU and under
    force_ref() (counted under `ref`); through elementwise.FusedChain under
    autograd, whose backward recomputes the plain composition. Raises
    (ValueError) where the chain's value is not of x's dtype, on either
    tier, as the JAX kernel does (elementwise.check_dtype)."""
    kernel = _device_of(x, *sides).type == "cuda" and use_kernel()
    _chain.check_dtype(x, steps, sides)
    if needs_grad(x, *sides):
        return _chain.FusedChain.apply(x, tuple(steps), kernel, *sides)
    if kernel:
        return _chain.fused_chain_cuda(x, steps, sides)
    global_profile.count_op(_chain.counter(x.dtype), "ref")
    return _chain.fused_chain_ref(x, steps, sides)


def rope_apply(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    _device_of(x, cos, sin)
    global_profile.count_op("rope", "torch")
    return refs.rope_apply(x, cos, sin)


def megacall_enabled(name: str) -> bool:
    """Whether the whole-stack decode megacall `name` ("stack_decode", K14, or
    "tape_decode", K15) may run: its flag on and the switches leaving it on
    (config.kernel_on), as the JAX package's use_pallas(name) (zgml_tpu/ops/
    dispatch.py:41-52). A disabled megacall runs the per-layer path (the
    model's choice), not its plain version; force_ref() keeps the path and
    runs the plain versions."""
    flag = config.tape_decode if name == "tape_decode" else config.stack_decode
    return flag() and config.kernel_on(name)


def stacked_decode(x, stack, ck, cv, pos, cos, sin):
    """K14: one batch-1 decode token through every layer of `stack`
    (ops/stackkernel.py StackedLayers) over the stacked bf16 or f32 cache,
    written in place at pos; returns (x_out, k_cur [L, Hkv, hd], v_cur). No
    backward: the JAX package has no VJP for it. Counted under
    stackkernel.counter (stack_decode, stack_decode_f32kv)."""
    _refuse_grad("stacked_decode (K14)", x, cos, sin)
    if _use_kernel("stack_decode", x, ck, cv, stack.table):
        return stackkernel.stacked_decode_cuda(x, stack, ck, cv, pos, cos, sin)
    global_profile.count_op(stackkernel.counter(stackkernel.kv_form(ck)), "ref")
    return stackkernel.stacked_decode_ref(x, stack, ck, cv, pos, cos, sin)


def tape_decode(x, tape, ck, cv, pos, cos, sin):
    """K15: stacked_decode's contract over `tape` (ops/tapekernel.py Tape),
    with bf16 operands unless ZGML_TPU_TAPE_BF16=0 (counted under
    tape_decode_f32 then; + _f32kv over the f32 cache, tapekernel.counter).
    No backward, as K14."""
    _refuse_grad("tape_decode (K15)", x, cos, sin)
    bf16 = config.tape_bf16()
    if _use_kernel("tape_decode", x, ck, cv, tape.stack.table):
        return tapekernel.tape_decode_cuda(x, tape, ck, cv, pos, cos, sin, bf16)
    global_profile.count_op(tapekernel.counter(bf16, stackkernel.kv_form(ck)), "ref")
    return tapekernel.tape_decode_ref(x, tape, ck, cv, pos, cos, sin, bf16)
