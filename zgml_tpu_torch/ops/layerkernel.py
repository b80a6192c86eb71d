"""K7: the fused decode attention block and its plain version.

Counterpart of zgml_tpu/ops/layerkernel.py `_layer_kernel` through
`attn_block_step(..., kv_layer=li)` (layerkernel.py:738-851): for one token
(batch 1) at position `pos` it computes rmsnorm, the fused QKV projection,
half-split RoPE, attention of each query head over layer li's cache rows
j < pos plus the current token's own f32 K/V as the last column, the output
projection and the residual, with wqkv and wo both Q4_0 or both Q8_0 (the
JAX `kind`). Ported: the f32 A phase and the bf16 cache; not ported: the
int8 A phase (`a_i8`, d >= 4096), the int8 cache, phase E.

Layouts: x f32 [1, 1, d]; the stacked bf16 cache ck / cv [L, 1, Hkv, S, hd]
(models/llama.py), which both versions write IN PLACE at (li, 0, :, pos) with
the current K/V rounded to bf16 (the JAX package writes all layers' rows
after its layer loop; the cache contents are the same). cos / sin are the
[1, hd/2] tables of `pos` (refs.rope_cos_sin). On the card `pos` is an int32
[1] tensor on the device, as K4 reads kv_len, so a step needs no host value.
Callers go through ``ops.dispatch.attn_block``.
"""
from __future__ import annotations

import torch

from zgml_tpu_torch.ops import build, coop, refs
from zgml_tpu_torch.ops.qmatmul import KIND_CODE, counter
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
    `_layer_step` where JAX runs K7."""
    return (batch == 1 and head_dim in HEAD_DIMS and len(set(kinds)) == 1
            and kinds[0] in KIND_CODE)


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
                   eps: float):
    """Returns (x_out [1, 1, d], k_cur [1, Hkv, 1, hd] rotated, v_cur), all f32,
    and writes the cache row pos of layer li."""
    d, hd = _heads(x, wqkv, wo, n_heads, n_kv_heads)
    p = int(pos.reshape(-1)[0]) if isinstance(pos, torch.Tensor) else int(pos)
    nq, nkv = n_heads * hd, n_kv_heads * hd
    h = refs.rmsnorm(x, gamma, eps)
    qkv = refs.qmatmul_ref(h, wqkv)                                     # [1, 1, n]
    q = qkv[..., :nq].reshape(1, 1, n_heads, hd).transpose(1, 2)
    k = qkv[..., nq:nq + nkv].reshape(1, 1, n_kv_heads, hd).transpose(1, 2)
    v = qkv[..., nq + nkv:].reshape(1, 1, n_kv_heads, hd).transpose(1, 2)
    q = refs.rope_apply(q, cos, sin)
    k = refs.rope_apply(k, cos, sin)
    keys = torch.cat([ck[li, :, :, :p].to(torch.float32), k], dim=2)  # self column last
    vals = torch.cat([cv[li, :, :, :p].to(torch.float32), v], dim=2)
    att = refs.gqa_attention_ref(q, keys, vals).transpose(1, 2).reshape(1, 1, nq)
    ck[li, :, :, p] = k[:, :, 0].to(ck.dtype)
    cv[li, :, :, p] = v[:, :, 0].to(cv.dtype)
    return x + refs.qmatmul_ref(att, wo), k, v


def attn_block_cuda(x: torch.Tensor, gamma: torch.Tensor, wqkv: PackedWeight,
                    wo: PackedWeight, ck: torch.Tensor, cv: torch.Tensor, li: int,
                    pos: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, n_heads: int,
                    n_kv_heads: int, eps: float):
    """Launch K7 (csrc/layer_attn.cu) at the weights' kind; same contract as
    attn_block_ref, with pos an int32 [1] CUDA tensor."""
    def require(cond, msg):
        if not cond:
            raise ValueError(f"attn_block: {msg}")
    dev = x.device
    require(x.is_cuda and all(t.device == dev for t in
                              (gamma, wqkv.qs, wqkv.d, wo.qs, wo.d, ck, cv, cos, sin)),
            f"x on {x.device}: every tensor must be on one CUDA device")
    require(isinstance(pos, torch.Tensor) and pos.device == dev and pos.dtype == torch.int32
            and pos.numel() == 1, "pos must be an int32 [1] tensor on the card")
    require(wqkv.kind == wo.kind, f"wqkv is {wqkv.kind}, wo {wo.kind}: one kind")
    d, hd = _heads(x, wqkv, wo, n_heads, n_kv_heads)
    require(hd in HEAD_DIMS, f"head_dim {hd} not in {HEAD_DIMS}")
    require(x.dtype == torch.float32 and x.numel() == d,
            f"x must be one float32 row, got {x.dtype} {tuple(x.shape)}")
    require(ck.dtype == torch.bfloat16 and cv.dtype == torch.bfloat16 and ck.shape == cv.shape
            and ck.dim() == 5 and ck.shape[1] == 1 and ck.shape[2] == n_kv_heads
            and ck.shape[4] == hd and 0 <= li < ck.shape[0],
            f"cache {tuple(ck.shape)} {ck.dtype}: want bf16 [L, 1, {n_kv_heads}, S, {hd}], "
            f"layer {li}")
    require(cos.dtype == torch.float32 and sin.dtype == torch.float32
            and cos.numel() == hd // 2 and sin.numel() == hd // 2,
            f"cos/sin must be float32 [{hd // 2}]")
    tensors = (x, gamma, wqkv.qs, wqkv.d, wo.qs, wo.d, ck, cv, cos, sin)
    require(all(t.is_contiguous() for t in tensors), "every input must be contiguous")
    require(wqkv.qs.data_ptr() % 16 == 0 and wo.qs.data_ptr() % 16 == 0,
            "the weights' qs planes must be 16-byte aligned")
    s = ck.shape[3]
    lib = build.library()
    n_split = lib.zgml_decode_split_count(s)          # phase B chunks as K4's
    x_out = torch.empty_like(x)
    kv_cur = torch.empty((2, n_kv_heads, hd), dtype=torch.float32, device=dev)
    scratch = torch.empty(2 * n_heads * hd + n_heads * n_split * (hd + 2),
                          dtype=torch.float32, device=dev)
    q_s, att_s, part_s = scratch.split([n_heads * hd, n_heads * hd, n_heads * n_split * (hd + 2)])
    status = lib.zgml_attn_block(
        KIND_CODE[wqkv.kind], x.data_ptr(), gamma.data_ptr(), wqkv.qs.data_ptr(),
        wqkv.d.data_ptr(), wo.qs.data_ptr(), wo.d.data_ptr(), cos.data_ptr(), sin.data_ptr(),
        ck[li].data_ptr(), cv[li].data_ptr(), pos.data_ptr(), x_out.data_ptr(),
        kv_cur.data_ptr(), q_s.data_ptr(), att_s.data_ptr(), part_s.data_ptr(),
        coop.barrier_words(dev).data_ptr(), d, n_heads, n_kv_heads, hd, s,
        float(eps), 1.0 / hd ** 0.5, torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, "attn_block")
    global_profile.count_op(counter("attn_block", wqkv.kind), "cuda")
    kv = kv_cur.reshape(2, 1, n_kv_heads, 1, hd)
    return x_out, kv[0], kv[1]
