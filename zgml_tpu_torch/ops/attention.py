"""K3/K4 and K9/K8: flash prefill and decode attention over the bf16 and the
int8 KV cache, kernels and plain versions.

Counterpart of zgml_tpu/ops/attention.py `_flash_kernel` (K3),
`_decode_kernel` (K4), `_flash_q8_kernel` (K9) and `_decode_q8_kernel` (K8),
with the JAX package's layouts at the public functions except the int8
cache's, which is position-major as the bf16 one (quant/kv_cache.py):

  q       f32  [B, Hq, Tq, d]        (Tq = 1 for decode)
  k, v    bf16 [R, Hkv, S, d]        the KV cache slab, read in place; batch
                                     row b of the query reads cache row
                                     kv_row + b (the stacked [L, B, ...] cache
                                     viewed as [L*B, ...], kv_row = layer * B)
       or int8 [R, Hkv, S, d] with ks, vs f32 [R, Hkv, S], one scale per
                                     position (K8, K9)

``*_cuda`` launch csrc/flash_attn.cu and csrc/decode_attn.cu (the int8
cache is a mode of each); ``*_ref`` are the plain torch versions, with the
masks of zgml_tpu/ops/dispatch.py (177-188, 237-246). The int8 ones compute
the kernels' functions, not the JAX ref tier's dequantize-then-attend:
K8 quantizes q per query head (attention.py:529-533) and takes integer
q.k dots, K9 keeps q f32 (the port's prefill is ZGML_TPU_PREFILL_BF16=0);
both fold the per-position scales into the scores and into p.
Callers go through ``ops.dispatch``.
"""
from __future__ import annotations

import torch

from zgml_tpu_torch.ops import build, refs
from zgml_tpu_torch.quant.kv_cache import quantize_columns
from zgml_tpu_torch.runtime.profile import global_profile

HEAD_DIMS = (16, 32, 64, 128)     # compiled instantiations of K3, K4, K8 and K9


def flash_attention_ref(q, k, v, kv_len=None, q_offset: int = 0, kv_row: int = 0):
    """Causal GQA prefill attention: query row i (absolute q_offset + i)
    attends keys j < kv_len with j <= q_offset + i."""
    b, tq = q.shape[0], q.shape[2]
    k, v = k[kv_row:kv_row + b], v[kv_row:kv_row + b]
    s = k.shape[2]
    if kv_len is None:
        kv_len = s
    ki = torch.arange(s, device=q.device)[None, :]
    qi = torch.arange(tq, device=q.device)[:, None] + q_offset
    mask = (ki < kv_len) & (ki <= qi)                       # [Tq, S]
    return refs.gqa_attention_ref(q, k, v, mask[None, None])


def decode_attention_ref(q, k, v, kv_len, kv_row: int = 0):
    """One query token per batch row over the cache prefix: row b attends
    keys j < kv_len[b] (kv_len an int or an int tensor [B])."""
    b = q.shape[0]
    k, v = k[kv_row:kv_row + b], v[kv_row:kv_row + b]
    s = k.shape[2]
    lens = torch.as_tensor(kv_len, device=q.device).reshape(-1, 1)
    valid = torch.arange(s, device=q.device)[None, :] < lens  # [B or 1, S]
    return refs.gqa_attention_ref(q, k, v, valid[:, None, None, :])


def softmax_pv(s: torch.Tensor, v: torch.Tensor, vs: torch.Tensor) -> torch.Tensor:
    """The P.V half of the int8-cache kernels: s f32 [..., R, S] scores
    (masked keys -inf), v [..., S, d] levels (or values), vs [..., S] their
    scales -> f32 [..., R, d] = sum_j (p_j * vs_j) * v_j / l with p = exp(s -
    max), l = sum p (the V scales folded into p, as attention.py:439 and
    layerkernel.py:262-267); a row with no live key gives 0."""
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("...rs,...sd->...rd", p * vs[..., None, :], v.to(torch.float32))
    return o / torch.where(l > 0, l, torch.ones_like(l))


def _rows(kv_row: int, b: int, *tensors):
    return [t[kv_row:kv_row + b] for t in tensors]


def decode_attention_q8_ref(q, k, ks, v, vs, kv_len, kv_row: int = 0):
    """K8's function: one query token per batch row over the int8 cache
    prefix j < kv_len[b]. q is quantized per query head as the kernel does
    (quantize_columns over d), the scores are the exact integer dots times
    q_scale * k_scale * 1/sqrt(d) (attention.py:425-426), and P.V runs in
    f32 on the int8 levels with the V scales folded into p."""
    b, hq, _, d = q.shape
    k, ks, v, vs = _rows(kv_row, b, k, ks, v, vs)
    hkv, s = k.shape[1], k.shape[2]
    qq, qs = quantize_columns(q.reshape(b, hkv, hq // hkv, d))     # [B, Hkv, n_rep, d]
    # integers below 2^24 (|level| <= 127, d <= 256): exact in f32 in any order
    dots = torch.einsum("bgrd,bgsd->bgrs", qq.to(torch.float32), k.to(torch.float32))
    sc = qs[..., None] * ks[:, :, None, :] * (1.0 / d ** 0.5)
    lens = torch.as_tensor(kv_len, device=q.device).reshape(-1, 1, 1, 1)
    live = torch.arange(s, device=q.device)[None, None, None, :] < lens
    scores = torch.where(live, dots * sc, torch.full_like(dots, float("-inf")))
    return softmax_pv(scores, v, vs).reshape(b, hq, 1, d)


def flash_attention_q8_ref(q, k, ks, v, vs, kv_len=None, q_offset: int = 0, kv_row: int = 0):
    """K9's function: causal GQA prefill over the int8 cache, q f32, scores
    (q . k_levels) * (k_scale * 1/sqrt(d)) (attention.py:629-631), query row
    i (absolute q_offset + i) attending keys j < kv_len with j <= q_offset +
    i, P.V with the V scales folded into p."""
    b, hq, tq, d = q.shape
    k, ks, v, vs = _rows(kv_row, b, k, ks, v, vs)
    hkv, s = k.shape[1], k.shape[2]
    if kv_len is None:
        kv_len = s
    qg = q.to(torch.float32).reshape(b, hkv, hq // hkv * tq, d)     # rows (rep, i)
    dots = torch.einsum("bgrd,bgsd->bgrs", qg, k.to(torch.float32))
    scores = dots * (ks * (1.0 / d ** 0.5))[:, :, None, :]
    ki = torch.arange(s, device=q.device)[None, :]
    qi = torch.arange(qg.shape[2], device=q.device)[:, None] % tq + q_offset
    mask = (ki < kv_len) & (ki <= qi)
    scores = torch.where(mask, scores, torch.full_like(scores, float("-inf")))
    return softmax_pv(scores, v, vs).reshape(b, hq, tq, d)


def check_qkv(name: str, q, k, v, kv_row: int, tq: int | None, scales=None):
    def require(cond, msg):
        if not cond:
            raise ValueError(f"{name}: {msg}")
    require(q.is_cuda and k.device == q.device and v.device == q.device,
            f"q on {q.device}, k on {k.device}, v on {v.device}: one CUDA device")
    require(q.dtype == torch.float32, f"q must be float32, got {q.dtype}")
    want = torch.bfloat16 if scales is None else torch.int8
    require(k.dtype == want and v.dtype == want, f"k/v must be {want}, got {k.dtype}/{v.dtype}")
    require(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape,
            f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: want 4-d, k == v")
    b, hq, t, d = q.shape
    r, hkv, _, dk = k.shape
    require(d == dk and d in HEAD_DIMS, f"head_dim {d} (cache {dk}) not in {HEAD_DIMS}")
    require(hkv > 0 and hq % hkv == 0, f"Hq={hq} not a multiple of Hkv={hkv}")
    require(tq is None or t == tq, f"q has Tq={t}, want {tq}")
    require(0 <= kv_row and kv_row + b <= r, f"kv_row {kv_row} + B {b} exceeds cache rows {r}")
    require(q.is_contiguous() and k.is_contiguous() and v.is_contiguous(),
            "q, k and v must be contiguous")
    require(all(t_.data_ptr() % 16 == 0 for t_ in (q, k, v)), "q, k, v must be 16-byte aligned")
    if scales is not None:
        require(all(t_.device == q.device and t_.dtype == torch.float32
                    and t_.shape == k.shape[:3] and t_.is_contiguous() for t_ in scales),
                f"ks/vs must be contiguous float32 {tuple(k.shape[:3])} on {q.device}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def flash_attention_cuda(q, k, v, kv_len=None, q_offset: int = 0, kv_row: int = 0):
    """Launch K3. kv_len, q_offset and kv_row are host ints."""
    return _flash(q, k, None, v, None, kv_len, q_offset, kv_row)


def flash_attention_q8_cuda(q, k, ks, v, vs, kv_len=None, q_offset: int = 0, kv_row: int = 0):
    """Launch K9 (K3's int8-cache mode). kv_len, q_offset, kv_row host ints."""
    return _flash(q, k, ks, v, vs, kv_len, q_offset, kv_row)


def _flash(q, k, ks, v, vs, kv_len, q_offset, kv_row):
    name = "attention" if ks is None else "flash_attention_q8"
    check_qkv(name, q, k, v, kv_row, None, None if ks is None else (ks, vs))
    b, hq, tq, d = q.shape
    _, hkv, s, _ = k.shape
    kv_len = s if kv_len is None else int(kv_len)
    o = torch.empty_like(q)
    status = build.library().zgml_flash_attention(
        q.data_ptr(), k.data_ptr(), _ptr(ks), v.data_ptr(), _ptr(vs), o.data_ptr(), None, b, hq,
        hkv, tq, s, d, kv_len, int(q_offset), int(kv_row), 1.0 / d ** 0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(status, name)
    global_profile.count_op(name, "cuda")
    return o


def decode_attention_cuda(q, k, v, kv_len, kv_row: int = 0):
    """Launch K4. kv_len: int32 CUDA tensor [B] (or an int, made into one)."""
    return _decode(q, k, None, v, None, kv_len, kv_row)


def decode_attention_q8_cuda(q, k, ks, v, vs, kv_len, kv_row: int = 0):
    """Launch K8 (K4's int8-cache mode; q quantized per query head in the
    kernel). kv_len: int32 CUDA tensor [B] (or an int, made into one)."""
    return _decode(q, k, ks, v, vs, kv_len, kv_row)


def _decode(q, k, ks, v, vs, kv_len, kv_row):
    name = "decode_attention" if ks is None else "decode_attention_q8"
    check_qkv(name, q, k, v, kv_row, 1, None if ks is None else (ks, vs))
    b, hq, _, d = q.shape
    _, hkv, s, _ = k.shape
    if not isinstance(kv_len, torch.Tensor):
        kv_len = torch.full((b,), int(kv_len), dtype=torch.int32, device=q.device)
    if (kv_len.device != q.device or kv_len.dtype != torch.int32
            or kv_len.shape != (b,) or not kv_len.is_contiguous()):
        raise ValueError(f"{name}: kv_len must be a contiguous int32 [{b}] tensor on {q.device}")
    lib = build.library()
    n_split = lib.zgml_decode_split_count(s)
    part = torch.empty((b * hq, n_split, d + 2), dtype=torch.float32, device=q.device)
    o = torch.empty_like(q)
    status = lib.zgml_decode_attention(
        q.data_ptr(), k.data_ptr(), _ptr(ks), v.data_ptr(), _ptr(vs), kv_len.data_ptr(),
        o.data_ptr(), part.data_ptr(), b, hq, hkv, s, d, int(kv_row), 1.0 / d ** 0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(status, name)
    global_profile.count_op(name, "cuda")
    return o
