"""K7: the fused decode attention block and its plain version.

Counterpart of zgml_tpu/ops/layerkernel.py `_layer_kernel` through
`attn_block_step(..., kv_layer=li)` (layerkernel.py:738-851): for one token
(batch 1) at position `pos` it computes rmsnorm, the fused QKV projection,
half-split RoPE, attention of each query head over layer li's cache rows
j < pos plus the current token's own f32 K/V as the last column, the output
projection and the residual, with wqkv and wo both Q4_0 or both Q8_0 (the
JAX `kind`). Ported: both A phases, f32 and int8 (`a_i8`, layerkernel.py:
148-190, on where config.attn_i8a(dp) holds: by default at padded d >=
4096), both caches, bf16 and int8 (`kv_i8`), and phase E (`has_ffn`,
layerkernel.py:91-123, 758-765, under ZGML_TPU_LAYER_FFN=1 at Q4_0), and
over the f32 cache too (the JAX package's init_cache(batch, float32): the
rows read in f32, the row at pos written as k_cur / v_cur are,
layerkernel.py:311-314; csrc/layer_attn_f32.cu): with
``ffn`` = (ffn_norm, w_gate_up, w_down) the same launch then runs the
layer's FFN, K6d's f32 function at one row, on its output (x_out = x2 +
down(silu(gate(n)) * up(n)), n = rmsnorm(x2) * ffn_norm), whatever the A
phase, as JAX's has_ffn ignores the i8a flag; its plain version is the
chain attn_block_ref then ffn.fused_ffn_norm_ref.

With the int8 cache (quant/kv_cache.py) the cache rows j < pos are attended
as the JAX kernel does (layerkernel.py:223-267): q quantized per head after
RoPE (quantize_columns), scores = integer q.k dots * (q_scale * k_scale) *
1/sqrt(hd), P.V on the int8 levels with the V scales folded into p. The
current token stays an f32 self column from the unquantized q and k_cur
(274-289); its K/V are then written to row pos quantized as
quantize_columns does (llama.py:377-385). On the card the kernel quantizes q
and writes the int8 row itself; a check can pass `q8_out` to receive its
int8 q and scales and `q8` to feed them to the plain version (a q value at a
rounding boundary can land one level apart when the two sum the projection
in another order), as `act_out` / `act` for the int8 A phase.

With a_i8 the QKV projection takes K1's int8 block dots on the normed row
quantized per 32-block (qmatmul.rmsnorm_quantize_ref, the JAX pre-pass of
layerkernel.py:774-792); on the card the kernel quantizes in its own
prologue, and a check can pass `act_out` to receive those activations and
`act` to feed them to the plain version (a row near a rounding boundary can
land one level apart when the two sum the norm in another order).

Layouts: x f32 [1, 1, d]; the stacked bf16 or f32 cache ck / cv [L, 1, Hkv,
S, hd] (models/llama.py), or the int8 one as ck = (k int8 [L, 1, Hkv, S, hd], k_s
f32 [L, 1, Hkv, S]) and cv likewise (the JAX package's tuple convention),
which both versions write IN PLACE at (li, 0, :, pos) with the current K/V
rounded to bf16 or quantized (the JAX package writes the rows after the
kernel; the cache contents are the same). cos / sin are the
[1, hd/2] tables of `pos` (refs.rope_cos_sin). On the card `pos` is an int32
[1] tensor on the device, as K4 reads kv_len, so a step needs no host value.
Callers go through ``ops.dispatch.attn_block``.
"""
from __future__ import annotations

import torch

from zgml_tpu_torch.ops import build, coop, decode_plan, refs
from zgml_tpu_torch.ops.attention import softmax_pv
from zgml_tpu_torch.ops.qmatmul import KIND_CODE, counter, i8_dot_ref, rmsnorm_quantize_ref
from zgml_tpu_torch.quant import kv_cache
from zgml_tpu_torch.quant.packed import PackedWeight
from zgml_tpu_torch.runtime.profile import global_profile

HEAD_DIMS = tuple(range(32, 257, 32))    # compiled instantiations of csrc/layer_attn.cu


def attn_block_compatible(head_dim: int, batch: int, kinds: tuple[str, str]) -> bool:
    """The JAX rule (attn_block_compatible, layerkernel.py:713-735) on the
    port's weights: B == 1, wqkv and wo of one kind, q4_0 or q8_0 (`kinds`
    = their kinds), head_dim % 32 == 0 and >= 32. Its wo-width check (padded
    d of wo <= padded d of wqkv) holds for every width the JAX loader pads,
    so it adds nothing here. One difference: the port compiles head dims up
    to 256 (every llama-family model), and a larger head_dim runs
    `_layer_step` where JAX runs K7. With the int8 cache the JAX rule also
    asks that the cache's head_dim be the config's (layerkernel.py:718-721),
    which the port's cache holds by construction."""
    return (batch == 1 and head_dim in HEAD_DIMS and len(set(kinds)) == 1
            and kinds[0] in KIND_CODE)


def cache_form(ck) -> int:
    """K7's cache form (decode_plan.KV_*): the int8 cache's (levels, scales)
    tuple, an f32 slab, else bf16."""
    if isinstance(ck, tuple):
        return decode_plan.KV_INT8
    return decode_plan.KV_F32 if ck.dtype == torch.float32 else decode_plan.KV_BF16


def counter_name(a_i8: bool, kv: int, kind: str, ffn: bool = False) -> str:
    """K7's placement counter for its A phase, cache form (cache_form; False
    / True stand for bf16 / int8), phase E and kind: attn_block,
    attn_block_i8, each + _kv8 over the int8 cache and + _f32kv over the f32
    one, each with _q8 at Q8_0; with phase E (Q4_0) the same names + _ffn."""
    name = ("attn_block" + ("_i8" if a_i8 else "")
            + {decode_plan.KV_INT8: "_kv8", decode_plan.KV_F32: "_f32kv"}.get(int(kv), ""))
    return counter(name + ("_ffn" if ffn else ""), kind)


def _heads(x, wqkv, wo, n_heads, n_kv_heads):
    d = x.shape[-1]
    hd = wo.k // n_heads
    if (wqkv.k != d or wqkv.n != (n_heads + 2 * n_kv_heads) * hd or wo.n != d
            or wo.k != n_heads * hd or n_heads % n_kv_heads):
        raise ValueError(f"attn_block: x D={d}, wqkv [{wqkv.n}, {wqkv.k}], wo [{wo.n}, "
                         f"{wo.k}] do not fit {n_heads}/{n_kv_heads} heads")
    return d, hd


def attn_block_ref(x: torch.Tensor, gamma: torch.Tensor, wqkv: PackedWeight,
                   wo: PackedWeight, ck: torch.Tensor, cv: torch.Tensor, li: int, pos,
                   cos: torch.Tensor, sin: torch.Tensor, n_heads: int, n_kv_heads: int,
                   eps: float, a_i8: bool = False, act=None, q8=None, mm=refs.qmatmul_ref):
    """Returns (x_out [1, 1, d], k_cur [1, Hkv, 1, hd] rotated, v_cur), all f32,
    and writes the cache row pos of layer li. a_i8: the int8 A phase, on
    `act` = (xq, xs) when given, else on rmsnorm_quantize_ref's. With the
    int8 cache, q8 = (qq int8 [Hq, hd], qs f32 [Hq]) replaces the plain
    quantization of q where given. mm(x, W) computes the f32 projections (K15's
    plain version passes its bf16-operand one, ops/tapekernel.py)."""
    _, hd = _heads(x, wqkv, wo, n_heads, n_kv_heads)
    p = int(pos.reshape(-1)[0]) if isinstance(pos, torch.Tensor) else int(pos)
    nq = n_heads * hd
    q, k, v = qkv_ref(x, gamma, wqkv, cos, sin, n_heads, n_kv_heads, hd, eps, a_i8, act, mm)
    if isinstance(ck, tuple):
        att = _attend_kv8(q, k, v, ck, cv, li, p, hd, q8).reshape(1, 1, nq)
        kv_cache.write(ck, cv, li, p, k, v)
    else:
        keys = torch.cat([ck[li, :, :, :p].to(torch.float32), k], dim=2)  # self column last
        vals = torch.cat([cv[li, :, :, :p].to(torch.float32), v], dim=2)
        att = refs.gqa_attention_ref(q, keys, vals).transpose(1, 2).reshape(1, 1, nq)
        ck[li, :, :, p] = k[:, :, 0].to(ck.dtype)
        cv[li, :, :, p] = v[:, :, 0].to(cv.dtype)
    return x + mm(att, wo), k, v


def attn_block_ffn_ref(x, gamma, wqkv: PackedWeight, wo: PackedWeight, ck, cv, li: int, pos,
                       cos, sin, n_heads: int, n_kv_heads: int, eps: float, ffn,
                       a_i8: bool = False, act=None, q8=None):
    """K7 with phase E, plain: attn_block_ref, then on its x_out K6d's f32
    function (ffn.fused_ffn_norm_ref, no int8 mode) with ffn = (ffn_norm,
    w_gate_up, w_down). Returns (x_out, k_cur, v_cur)."""
    from zgml_tpu_torch.ops.ffn import fused_ffn_norm_ref
    x2, k, v = attn_block_ref(x, gamma, wqkv, wo, ck, cv, li, pos, cos, sin, n_heads,
                              n_kv_heads, eps, a_i8, act, q8)
    return fused_ffn_norm_ref(x2, *ffn, eps), k, v


def qkv_ref(x, gamma, wqkv: PackedWeight, cos, sin, n_heads: int, n_kv_heads: int, hd: int,
            eps: float, a_i8: bool = False, act=None, mm=refs.qmatmul_ref):
    """K7's phase A, plain: rmsnorm, the QKV projection (f32 through mm, or
    with a_i8 K1's block dots on `act` or rmsnorm_quantize_ref's activations)
    and RoPE -> q [1, Hq, 1, hd], k and v [1, Hkv, 1, hd], f32."""
    d = x.shape[-1]
    nq, nkv = n_heads * hd, n_kv_heads * hd
    if a_i8:
        xq, xs = rmsnorm_quantize_ref(x, gamma, eps) if act is None else act
        qkv = i8_dot_ref(xq.reshape(1, d), xs.reshape(1, d // 32), wqkv).reshape(1, 1, -1)
    else:
        qkv = mm(refs.rmsnorm(x, gamma, eps), wqkv)                    # [1, 1, n]
    q = qkv[..., :nq].reshape(1, 1, n_heads, hd).transpose(1, 2)
    k = qkv[..., nq:nq + nkv].reshape(1, 1, n_kv_heads, hd).transpose(1, 2)
    v = qkv[..., nq + nkv:].reshape(1, 1, n_kv_heads, hd).transpose(1, 2)
    return refs.rope_apply(q, cos, sin), refs.rope_apply(k, cos, sin), v


def _attend_kv8(q, k, v, ck, cv, li: int, p: int, hd: int, q8):
    """Phase B over the int8 cache rows j < p plus the f32 self column
    (layerkernel.py:223-289): q [1, Hq, 1, hd] rotated, k / v [1, Hkv, 1, hd]
    the current token's -> att f32 [Hkv, n_rep, hd]."""
    (kq, ks), (vq, vs) = ck, cv
    hkv = k.shape[1]
    qg = q.reshape(hkv, -1, hd)
    if q8 is None:
        qq, qs = kv_cache.quantize_columns(qg)
    else:
        qq, qs = q8[0].reshape(qg.shape), q8[1].reshape(qg.shape[:2])
    scale = 1.0 / hd ** 0.5
    dots = torch.einsum("grd,gsd->grs", qq.to(torch.float32), kq[li, 0, :, :p].to(torch.float32))
    s_cache = dots * (qs[..., None] * ks[li, 0, :, None, :p]) * scale
    s_self = torch.einsum("grd,gd->gr", qg, k[0, :, 0])[..., None] * scale
    vals = torch.cat([vq[li, 0, :, :p].to(torch.float32), v[0]], dim=1)     # [Hkv, p + 1, hd]
    scales = torch.cat([vs[li, 0, :, :p], torch.ones_like(vs[li, 0, :, :1])], dim=1)
    return softmax_pv(torch.cat([s_cache, s_self], dim=-1), vals, scales)


def attn_block_cuda(x: torch.Tensor, gamma: torch.Tensor, wqkv: PackedWeight,
                    wo: PackedWeight, ck: torch.Tensor, cv: torch.Tensor, li: int,
                    pos: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, n_heads: int,
                    n_kv_heads: int, eps: float, a_i8: bool = False, act_out=None,
                    q8_out=None, ffn=None):
    """Launch K7 (csrc/layer_attn.cu) at the weights' kind on the plan of
    decode_plan.attn_plan (cached per shape and card); same contract as
    attn_block_ref, with pos an int32 [1] CUDA tensor. a_i8: the int8 A
    phase; act_out = (xq int8 [d], xs f32 [d/32]) receives its activations
    where given. With the int8 cache (ck, cv tuples), q8_out = (qq int8
    [Hq, hd], qs f32 [Hq]) receives the quantized q where given. With ffn =
    (ffn_norm f32 [d], w_gate_up [2F, d], w_down [d, F], Q4_0) phase E runs
    in the same launch on decode_plan.attn_ffn_plan: attn_block_ffn_ref's
    contract. ck / cv bf16 or f32 slabs, or the int8 tuples. Counted under
    counter_name(a_i8, cache_form(ck), kind, ffn given)."""
    def require(cond, msg):
        if not cond:
            raise ValueError(f"attn_block: {msg}")
    dev = x.device
    kv = cache_form(ck)
    kv8 = kv == decode_plan.KV_INT8
    (ck, cks), (cv, cvs) = (ck, cv) if kv8 else ((ck, None), (cv, None))
    scales = (cks, cvs) if kv8 else ()
    require(x.is_cuda and all(t.device == dev for t in
                              (gamma, wqkv.qs, wqkv.d, wo.qs, wo.d, ck, cv, cos, sin, *scales)),
            f"x on {x.device}: every tensor must be on one CUDA device")
    require(isinstance(pos, torch.Tensor) and pos.device == dev and pos.dtype == torch.int32
            and pos.numel() == 1, "pos must be an int32 [1] tensor on the card")
    require(wqkv.kind == wo.kind, f"wqkv is {wqkv.kind}, wo {wo.kind}: one kind")
    d, hd = _heads(x, wqkv, wo, n_heads, n_kv_heads)
    require(hd in HEAD_DIMS, f"head_dim {hd} not in {HEAD_DIMS}")
    require(x.dtype == torch.float32 and x.numel() == d,
            f"x must be one float32 row, got {x.dtype} {tuple(x.shape)}")
    cdt = torch.int8 if kv8 else ck.dtype
    require(ck.dtype == cdt and cdt in (torch.int8, torch.bfloat16, torch.float32)
            and cv.dtype == cdt and ck.shape == cv.shape
            and ck.dim() == 5 and ck.shape[1] == 1 and ck.shape[2] == n_kv_heads
            and ck.shape[4] == hd and 0 <= li < ck.shape[0],
            f"cache {tuple(ck.shape)} {ck.dtype} / {cv.dtype}: want both bfloat16, float32 or "
            f"int8 levels [L, 1, {n_kv_heads}, S, {hd}], "
            f"layer {li}")
    require(all(t.dtype == torch.float32 and t.shape == ck.shape[:4] for t in scales),
            f"cache scales must be float32 {tuple(ck.shape[:4])}")
    require(cos.dtype == torch.float32 and sin.dtype == torch.float32
            and cos.numel() == hd // 2 and sin.numel() == hd // 2,
            f"cos/sin must be float32 [{hd // 2}]")
    tensors = (x, gamma, wqkv.qs, wqkv.d, wo.qs, wo.d, ck, cv, cos, sin, *scales)
    planes = [wqkv.qs, wqkv.d, wo.qs, wo.d]
    f = 0
    if ffn is not None:
        g2, gu, wd = ffn
        f = wd.k
        require(wqkv.kind == gu.kind == wd.kind == "q4_0",
                f"phase E takes q4_0 weights (JAX's has_ffn), got {wqkv.kind}, {gu.kind}, "
                f"{wd.kind}")
        require(g2.dtype == torch.float32 and g2.numel() == d and gu.k == d and gu.n == 2 * f
                and wd.n == d and f % 32 == 0,
                f"phase E: ffn_norm [{d}], w_gate_up [{gu.n}, {gu.k}], w_down [{wd.n}, "
                f"{wd.k}]; want [{d}], [2F, {d}], [{d}, F]")
        planes += [gu.qs, gu.d, wd.qs, wd.d]
        tensors += (g2, gu.qs, gu.d, wd.qs, wd.d)
        require(all(t.device == dev for t in tensors), "phase E's tensors must be on x's card")
    require(all(t.is_contiguous() for t in tensors), "every input must be contiguous")
    require(all(t.data_ptr() % 16 == 0 for t in planes),
            "the weights' qs and d planes must be 16-byte aligned (bulk copies)")
    s = ck.shape[3]
    lib = build.library()
    n_split = lib.zgml_decode_split_count(s)          # phase B chunks as K8's
    x_out = torch.empty_like(x)
    kv_cur = torch.empty((2, n_kv_heads, hd), dtype=torch.float32, device=dev)
    scratch = torch.empty(2 * n_heads * hd + n_heads * n_split * (hd + 2),
                          dtype=torch.float32, device=dev)
    q_s, att_s, part_s = scratch.split([n_heads * hd, n_heads * hd, n_heads * n_split * (hd + 2)])
    xq_p = xs_p = None
    if act_out is not None:
        require(a_i8 and act_out[0].dtype == torch.int8 and act_out[0].numel() == d
                and act_out[1].dtype == torch.float32 and act_out[1].numel() == d // 32
                and all(t.device == dev and t.is_contiguous() for t in act_out),
                f"act_out takes int8 [{d}] and float32 [{d // 32}] on {dev}, with a_i8")
        xq_p, xs_p = act_out[0].data_ptr(), act_out[1].data_ptr()
    qq_p = qs_p = None
    if q8_out is not None:
        require(kv8 and q8_out[0].dtype == torch.int8 and q8_out[0].numel() == n_heads * hd
                and q8_out[1].dtype == torch.float32 and q8_out[1].numel() == n_heads
                and all(t.device == dev and t.is_contiguous() for t in q8_out),
                f"q8_out takes int8 [{n_heads}, {hd}] and float32 [{n_heads}] on {dev}, with "
                f"the int8 cache")
        qq_p, qs_p = q8_out[0].data_ptr(), q8_out[1].data_ptr()
    if ffn is None:
        _, plan, bounds = decode_plan.launch_args(dev, decode_plan.attn_plan, d, n_heads,
                                                  n_kv_heads, hd, wqkv.kind, bool(a_i8), kv, s)
        e_args = (None,) * 6 + (0,)
    else:
        _, plan, bounds = decode_plan.launch_args(dev, decode_plan.attn_ffn_plan, d, n_heads,
                                                  n_kv_heads, hd, wqkv.kind, bool(a_i8), kv,
                                                  s, f)
        act = torch.empty(f, dtype=torch.float32, device=dev)
        e_args = (g2.data_ptr(), gu.qs.data_ptr(), gu.d.data_ptr(), wd.qs.data_ptr(),
                  wd.d.data_ptr(), act.data_ptr(), f)
    status = lib.zgml_attn_block(
        KIND_CODE[wqkv.kind], int(a_i8), kv, x.data_ptr(), gamma.data_ptr(),
        wqkv.qs.data_ptr(), wqkv.d.data_ptr(), wo.qs.data_ptr(), wo.d.data_ptr(),
        cos.data_ptr(), sin.data_ptr(), ck[li].data_ptr(), cv[li].data_ptr(),
        cks[li].data_ptr() if kv8 else None, cvs[li].data_ptr() if kv8 else None,
        pos.data_ptr(), x_out.data_ptr(), kv_cur.data_ptr(), q_s.data_ptr(), att_s.data_ptr(),
        part_s.data_ptr(), coop.barrier_words(dev).data_ptr(), xq_p, xs_p, qq_p, qs_p, d,
        n_heads, n_kv_heads, hd, s, float(eps), 1.0 / hd ** 0.5,
        coop.counter_words(dev, n_kv_heads).data_ptr(), *e_args, plan, bounds.data_ptr(),
        bounds.device.index, torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, "attn_block")
    global_profile.count_op(counter_name(a_i8, kv, wqkv.kind, ffn is not None), "cuda")
    kv = kv_cur.reshape(2, 1, n_kv_heads, 1, hd)
    return x_out, kv[0], kv[1]
