"""The int8 KV cache: per-position absmax quantization over head_dim.

Counterpart of zgml_tpu/quant/kv_cache.py (33-68), with the port's own
layout. The semantics are the JAX package's: every cached position of every
KV head is one int8 vector of head_dim levels and one f32 scale,

    scale = absmax(x) / 127,   inv = 1 / scale (0 where scale == 0),
    q = clip(round_half_even(x * inv), -127, 127),

so the scales factor out of both attention contractions (ops/attention.py
K8 / K9, ops/layerkernel.py K7's int8-cache mode).

The layout is position-major, as the bf16 cache (models/llama.py): the JAX
package's d-major [B, Hkv, d, S] exists for TPU lanes. Here

  k, v     int8 [L, B, Hkv, S, hd]   each position's hd levels contiguous
  k_s, v_s f32  [L, B, Hkv, S]       one scale per position

in one dict {"k", "k_s", "v", "v_s"}; the kernels read layer li through the
same kv_row offset as the bf16 cache's (the cache viewed as [L*B, ...]).
Scales start at 1 and levels at 0, as the JAX package's init_quant_cache.
"""
from __future__ import annotations

import numpy as np
import torch

from zgml_tpu_torch.quant.packed import resolve_device


def init_cache(n_layers: int, batch: int, n_kv_heads: int, max_seq: int, head_dim: int,
               device) -> dict:
    qs = (n_layers, batch, n_kv_heads, max_seq, head_dim)
    ss = qs[:-1]
    return {"k": torch.zeros(qs, dtype=torch.int8, device=device),
            "k_s": torch.ones(ss, dtype=torch.float32, device=device),
            "v": torch.zeros(qs, dtype=torch.int8, device=device),
            "v_s": torch.ones(ss, dtype=torch.float32, device=device)}


def quantize_columns(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [..., hd] -> (int8 [..., hd], f32 scales [...]): absmax/127 over the
    last axis, as the JAX quantize_columns (kv_cache.py:42-53) without its
    transpose to d-major. Few torch ops: on the card each is a launch, and
    the int8-cache prefill and batch > 1 decode run this per layer."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    # tensor / tensor: a true division on every device (torch on CUDA turns a
    # division by a Python scalar into a multiply by its reciprocal); where
    # scale is 0 the inverse is 0, as JAX's where(scale > 0, 1 / scale, 0)
    scale = amax / torch.full_like(amax, 127.0)
    inv = torch.where(scale > 0, torch.ones_like(scale) / scale, 0.0)
    q = (xf * inv[..., None]).round().clamp(-127, 127).to(torch.int8)
    return q, scale


def write(ck: tuple, cv: tuple, li: int, pos: int, k: torch.Tensor, v: torch.Tensor,
          wp: torch.Tensor | None = None, row0: int = 0):
    """Quantize k and v [B, Hkv, T, hd] (together: one set of launches) and
    write them IN PLACE into layer li of the cache's (levels, scales) pairs ck
    and cv: at positions pos..pos+T-1 of rows row0..row0+B-1 (every row, the
    JAX write_columns, kv_cache.py:56-61, or a batch-1 chunk into row row0,
    serving's prefill into a slot, zgml_tpu/models/llama.py:429-438), or, wp an int32
    tensor [B] on the cache's device and T 1, row b at its own position
    wp[b] (per-row decode, llama.py:443-447): indexed on the device, no host
    sync, no loop over rows."""
    q, s = quantize_columns(torch.stack([k, v]))
    t = k.shape[2]
    for (lv, sc), qi, si in ((ck, q[0], s[0]), (cv, q[1], s[1])):
        if wp is not None:
            rows, at = torch.arange(k.shape[0], device=wp.device), wp.long()
            lv[li][rows, :, at] = qi[:, :, 0]
            sc[li][rows, :, at] = si[:, :, 0]
        else:
            lv[li, row0:row0 + k.shape[0], :, pos:pos + t] = qi
            sc[li, row0:row0 + k.shape[0], :, pos:pos + t] = si


def dequantize(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """int8 [..., S, hd] and scales [..., S] -> f32 [..., S, hd]."""
    return q.to(torch.float32) * s[..., None]


def cache_from_jax(jax_cache: dict, device="cuda") -> dict:
    """The JAX package's int8 cache, as numpy, in the port's layout: its
    per-layer list {"k": [(k_q [B, Hkv, d, S], k_s [B, Hkv, S]), ...], "v":
    ...} (init_cache(batch, "int8") of a loaded model) -> {"k", "k_s", "v",
    "v_s"}, the same levels and scales moved to position-major, on `device`
    (the card unless device="cpu", as params_from_jax)."""
    device = resolve_device(device)
    out = {}
    for name in ("k", "v"):
        q = np.stack([np.asarray(layer[0]) for layer in jax_cache[name]])
        s = np.stack([np.asarray(layer[1]) for layer in jax_cache[name]])
        out[name] = torch.from_numpy(np.ascontiguousarray(q.swapaxes(-1, -2))).to(device)
        out[f"{name}_s"] = torch.from_numpy(s.astype(np.float32)).to(device)
    return out
