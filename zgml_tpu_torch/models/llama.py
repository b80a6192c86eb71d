"""Llama-family decoder over a stacked bf16 KV cache.

Counterpart of zgml_tpu/models/llama.py on the paths it runs over the
stacked cache, chosen as the JAX package chooses them (config.py flags):

  - batch-1 decode with ZGML_TPU_ATTN_BLOCK on (the default), a head_dim
    and weight kinds the layer kernel takes: per layer the fused attention
    block K7 (llama.py:773-811; its A phase int8 where ZGML_TPU_ATTN_I8A
    holds, by default at padded d >= 4096), then the fused FFN
    (`_ffn_after_attn`, llama.py:217-260: at Q4_0 K6c where ZGML_TPU_FFN_I8A
    holds, by default at padded d >= 4096, else K6d; K6a at Q8_0), or the
    composed FFN when ZGML_TPU_KERNELS_DISABLE=fused_ffn or at a width JAX
    does not fuse at;
  - everything else (prefill, batch > 1, ATTN_BLOCK=0): the per-layer
    `_layer_step(kv_layer=li)` path (llama.py:286-341) with fused `wqkv` and
    `w_gate_up` projections and K3/K4 attention; its FFN, for calls of at
    most 32 rows where JAX fuses there, is JAX's composition at Q4_0
    (rmsnorm, the f32 fused FFN K6b, the residual; llama.py:326-340) and one
    K6a launch at Q8_0 (the same function), else composed;
  - `_head_out` (llama.py:517-543): greedy through K5 when it applies, else
    the argmax over the logits.

Every projection's tier (K1 int8 for M <= 32, or K2) is picked in
ops/dispatch.qmatmul, at the weight's kind (Q4_0 or Q8_0). GQA, RMSNorm,
half-split RoPE, SwiGLU, tied or separate lm_head.

The KV cache has one layout, ``{"k", "v"}`` bf16 tensors [L, B, Hkv, S, d],
and ``forward`` writes the new positions into it IN PLACE (the JAX package
threads a new cache value through instead). Attention reads layer li's slab
through the kernels' kv_row offset (the cache viewed as [L*B, Hkv, S, d]),
without a copy.

``params`` is a plain dict, as in the JAX package: tok_embd/out_norm f32,
``layers`` a list of {attn_norm, ffn_norm, wqkv, wo, w_gate_up, w_down} with
PackedWeight projections, and lm_head (absent when tied). Inference only.
"""
from __future__ import annotations

import dataclasses

import torch

from zgml_tpu_torch import config
from zgml_tpu_torch.ops import dispatch as ops
from zgml_tpu_torch.ops import ffn, refs
from zgml_tpu_torch.ops.layerkernel import attn_block_compatible


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    n_layers: int
    max_seq_len: int = 2048
    rope_base: float = 10000.0
    rms_norm_eps: float = 1e-5
    tied_lm_head: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def n_rep(self) -> int:
        return self.n_heads // self.n_kv_heads


def _layer_step(cfg: LlamaConfig, x, layer: dict, ck, cv, li: int, pos: int, kv_len,
                cos, sin, decode: bool):
    """One block. x f32 [B, T, D]; ck/cv the whole [L, B, Hkv, S, d] cache,
    written in place at (li, :, :, pos:pos+T); kv_len an int (prefill) or an
    int32 tensor [B] (decode)."""
    b, t, _ = x.shape
    hd, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    nq, nkv = hq * hd, hkv * hd
    L, bb, _, s, _ = ck.shape

    h = ops.rmsnorm(x, layer["attn_norm"], cfg.rms_norm_eps)
    qkv = ops.qmatmul(h, layer["wqkv"])
    q = qkv[..., :nq].reshape(b, t, hq, hd).transpose(1, 2)
    k = qkv[..., nq:nq + nkv].reshape(b, t, hkv, hd).transpose(1, 2)
    v = qkv[..., nq + nkv:nq + 2 * nkv].reshape(b, t, hkv, hd).transpose(1, 2)
    q = ops.rope_apply(q, cos, sin)
    k = ops.rope_apply(k, cos, sin)
    ck[li, :, :, pos:pos + t] = k.to(ck.dtype)
    cv[li, :, :, pos:pos + t] = v.to(cv.dtype)
    rows_k, rows_v = ck.view(L * bb, hkv, s, hd), cv.view(L * bb, hkv, s, hd)
    if decode:
        att = ops.decode_attention(q, rows_k, rows_v, kv_len, kv_row=li * bb)
    else:
        att = ops.flash_attention(q, rows_k, rows_v, kv_len=kv_len, q_offset=pos,
                                  kv_row=li * bb)
    att = att.transpose(1, 2).reshape(b, t, nq)
    x = x + ops.qmatmul(att, layer["wo"])
    return _ffn(cfg, x, layer, after_attn_block=False)


def _ffn(cfg: LlamaConfig, x, layer: dict, after_attn_block: bool):
    """The FFN half of a layer, x + down(swiglu(gate|up(rmsnorm(x)))), fused
    where the JAX package fuses it (at most 32 rows, fused_ffn not disabled,
    a width and kind it fuses at: ops/ffn.ffn_fuses), else composed from two
    projections (llama.py:217-260, 326-340). Fused: after K7 one K6 launch
    with the norm and residual inside (K6c or K6d at Q4_0, picked in
    ops/dispatch; K6a at Q8_0); in `_layer_step` at Q4_0 rmsnorm, K6b and the
    residual, as JAX composes them, and at Q8_0 K6a (the same f32 sums)."""
    rows = x.numel() // x.shape[-1]
    kind = layer["w_down"].kind
    fuses = (rows <= ffn.FFN_MAX_ROWS and "fused_ffn" not in config.kernels_disabled()
             and layer["w_gate_up"].kind == kind
             and ffn.ffn_fuses(cfg.d_model, cfg.d_ff, kind, after_attn_block))
    if fuses and (after_attn_block or kind == "q8_0"):
        return ops.fused_ffn_norm(x, layer["ffn_norm"], layer["w_gate_up"], layer["w_down"],
                                  cfg.rms_norm_eps)
    h = ops.rmsnorm(x, layer["ffn_norm"], cfg.rms_norm_eps)
    if fuses:
        return x + ops.fused_ffn(h, layer["w_gate_up"], layer["w_down"])
    gu = ops.qmatmul(h, layer["w_gate_up"])
    f = gu.shape[-1] // 2
    ff = refs.swiglu(gu[..., :f], gu[..., f:])
    return x + ops.qmatmul(ff, layer["w_down"])


def _fused_decode(cfg: LlamaConfig, x, layers, ck, cv, pos: int, cos, sin):
    """Batch-1 decode of one token: K7 then the FFN per layer
    (llama.py:796-805); K7 writes each layer's K/V row at pos."""
    pos_t = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    for li, layer in enumerate(layers):
        x, _, _ = ops.attn_block(x, layer["attn_norm"], layer["wqkv"], layer["wo"], ck, cv, li,
                                 pos_t, cos, sin, cfg.n_heads, cfg.n_kv_heads, cfg.rms_norm_eps)
        x = _ffn(cfg, x, layer, after_attn_block=True)
    return x


class LlamaModel(torch.nn.Module):
    """Holds the config and the params dict; ``forward`` runs tokens through
    the stack against a cache from ``init_cache``."""

    def __init__(self, cfg: LlamaConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.params = params

    @property
    def device(self) -> torch.device:
        return self.params["tok_embd"].device

    def init_cache(self, batch: int) -> dict:
        c = self.cfg
        shape = (c.n_layers, batch, c.n_kv_heads, c.max_seq_len, c.head_dim)
        return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=self.device),
                "v": torch.zeros(shape, dtype=torch.bfloat16, device=self.device)}

    def body(self, tokens: torch.Tensor, cache: dict, pos: int) -> torch.Tensor:
        """tokens int [B, T] at positions pos.. -> hidden states f32 [B, T, D]
        before the final norm. Writes K/V of positions pos..pos+T-1 into
        `cache`; attention sees kv_len = pos + T (as llama.py:737)."""
        cfg = self.cfg
        b, t = tokens.shape
        ck, cv = cache["k"], cache["v"]
        if ck.shape[1] != b:
            raise ValueError(f"cache batch {ck.shape[1]}, tokens batch {b}")
        if pos + t > ck.shape[3]:
            raise ValueError(f"SequenceTooLong: pos {pos} + {t} tokens > {ck.shape[3]}")
        x = self.params["tok_embd"][tokens]
        positions = torch.arange(pos, pos + t, device=x.device)
        cos, sin = refs.rope_cos_sin(positions, cfg.head_dim, cfg.rope_base)
        decode = t == 1
        layers = self.params["layers"]
        if (decode and config.attn_block()
                and all(attn_block_compatible(cfg.head_dim, b, (ly["wqkv"].kind, ly["wo"].kind))
                        for ly in layers)):
            return _fused_decode(cfg, x, layers, ck, cv, pos, cos, sin)
        kv_len = pos + t
        if decode:
            kv_len = torch.full((b,), kv_len, dtype=torch.int32, device=x.device)
        for li, layer in enumerate(layers):
            x = _layer_step(cfg, x, layer, ck, cv, li, pos, kv_len, cos, sin, decode)
        return x

    def head(self, x: torch.Tensor, greedy: bool = False,
             tier_rows: int | None = None) -> torch.Tensor:
        """Final norm + lm_head: logits f32 [B, T, V], or with greedy the
        argmax ids int64 [B] of the last position (first index on ties; K5
        for batch 1). tier_rows: the row count of the call this head stands
        for (the prefill engine computes the last row of a chunk), which picks
        the projection's tier."""
        x = ops.rmsnorm(x, self.params["out_norm"], self.cfg.rms_norm_eps)
        lm_head = self.params.get("lm_head")
        if greedy and lm_head is not None:
            tok = ops.qmatmul_greedy(x[:, -1], lm_head)
            if tok is not None:
                return tok
        if lm_head is None:       # tied embeddings: logits = x @ embd.T
            logits = x.to(torch.float32) @ self.params["tok_embd"].to(torch.float32).T
        else:
            logits = ops.qmatmul(x, lm_head, tier_rows)
        if greedy:
            return torch.argmax(logits[:, -1], dim=-1)
        return logits

    def forward(self, tokens: torch.Tensor, cache: dict, pos: int,
                greedy_head: bool = False) -> torch.Tensor:
        """tokens [B, T] -> logits [B, T, V] (or next ids [B] with
        greedy_head); updates `cache` in place."""
        return self.head(self.body(tokens, cache, pos), greedy=greedy_head)
