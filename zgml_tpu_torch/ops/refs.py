"""Plain torch versions of every op on the slice (the port's oracle tier).

Counterpart of zgml_tpu/ops/refs.py, with the same formulas in the same
order, so on the CPU the port agrees with the JAX package up to the order of
f32 sums:

  - activations x are [..., K] f32; a projection is x @ dequant(W).T with W
    N-major like the GGUF file;
  - RoPE pairs (i, i + d/2) (rotate-half), f32 tables from refs.py:87-97;
  - attention scales scores by 1/sqrt(d); rows with no live key give 0.
"""
from __future__ import annotations

import torch

from zgml_tpu_torch.quant.packed import PackedWeight


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest even), in x's dtype (f32 or f64)."""
    return x.to(torch.bfloat16).to(x.dtype)


def qmatmul_ref(x: torch.Tensor, w: PackedWeight, bf16: bool = False) -> torch.Tensor:
    """x [..., K] @ dequant(W).T -> [..., N] f32 (the weight dequantized
    exactly, then one f32 matmul). bf16: JAX's dot_bf16 form
    (zgml_tpu/ops/qmatmul.py:57-63, 113-121), x and the dequantized weight
    level * scale (exact in f32) each rounded to bf16, then the f32 matmul,
    whose products are exact (on the card with TF32 off, torch's default)."""
    lead = x.shape[:-1]
    x2, wt = x.reshape(-1, x.shape[-1]).to(torch.float32), w.dequant()
    if bf16:
        x2, wt = bf16_round(x2), bf16_round(wt)
    return (x2 @ wt.T).reshape(*lead, w.n)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * gamma.to(torch.float32)).to(x.dtype)


def layernorm_ref(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm * gamma + beta over the last axis, in f32 (refs.py:76-82)."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * gamma + beta).to(x.dtype)


def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 base: float = 10000.0) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [T, head_dim // 2] for integer positions [T];
    freq_i = base^(-2i/d)."""
    half = head_dim // 2
    ar = torch.arange(half, dtype=torch.float32, device=positions.device)
    inv_freq = 1.0 / (base ** (ar * 2.0 / head_dim))
    ang = positions.to(torch.float32)[:, None] * inv_freq[None, :]
    return torch.cos(ang), torch.sin(ang)


def rope_apply(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotary embedding, half-split pairing. x [..., T, d]; cos/sin [T, d/2]."""
    half = x.shape[-1] // 2
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.cat([o1, o2], dim=-1).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x.to(torch.float32)).to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up."""
    return silu(gate) * up


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor | None = None, scale: float | None = None) -> torch.Tensor:
    """Softmax attention in f32. q [..., Tq, d], k/v [..., Tk, d]; mask
    broadcastable to [..., Tq, Tk], True = attend; scores scaled by `scale`,
    1/sqrt(d) where None."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("...qd,...kd->...qk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)          # rows with no live key -> 0
    return torch.einsum("...qk,...kd->...qd", p, v.to(torch.float32)).to(q.dtype)


def causal_mask(t_q: int, t_k: int, offset: int = 0, device=None) -> torch.Tensor:
    """Boolean mask [t_q, t_k]: query i attends keys j <= i + offset (aligned
    at the start, refs.py:143-147)."""
    qi = torch.arange(t_q, device=device)[:, None]
    kj = torch.arange(t_k, device=device)[None, :]
    return kj <= qi + offset


def gqa_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mask: torch.Tensor | None = None) -> torch.Tensor:
    """Grouped-query attention. q [B, Hq, Tq, d], k/v [B, Hkv, Tk, d]; mask
    broadcastable to [B, Hkv, Tq, Tk] (the n_rep axis is inserted here)."""
    b, hq, tq, d = q.shape
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, hq // hkv, tq, d)
    out = attention_ref(qg, k[:, :, None], v[:, :, None],
                        None if mask is None else mask[:, :, None])
    return out.reshape(b, hq, tq, d)
