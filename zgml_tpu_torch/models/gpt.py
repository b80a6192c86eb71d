"""GPT-2-style decoder over a stacked bf16 or f32 KV cache.

Counterpart of zgml_tpu/models/gpt.py: pre-LN blocks with one packed w_qkv
[D, 3D] projection, a tanh-GeLU FFN (jax.nn.gelu's default form; F.gelu's
default is the erf form), LayerNorm with gamma and beta, token plus
positional embeddings (learned wpe where the params hold it, else the
sinusoidal table) and the head tied to wte. It has the interface
runtime/engine.LlamaEngine calls (``init_cache``, ``body``, ``head``,
``forward`` with ``greedy_head``, ``device``), so the engine serves GPT as the
JAX engine does.

Kernels on the path, as the JAX model's (gpt.py:120-133): a prefill chunk's
attention is K3 (``dispatch.flash_attention``, in its bf16 form under the
default ZGML_TPU_PREFILL_BF16=1; its f32-K/V forms over the f32 cache), a
decode token's K4 (``dispatch.decode_attention``; its f32 form over the
f32 cache); both read layer li's slab of the stacked
cache [L, B, H, S, hd] through kv_row = li * B, as models/llama.py does.
The projections are dense f32 [K, N] and go through ``dispatch.qmatmul``
(torch.matmul), as the JAX package leaves them to XLA; the tied head, the
LayerNorms and the GeLU are plain torch too.

The JAX engine serves GPT with temperature-0 sampling (its forward has no
greedy head): ``forward(greedy_head=True)`` returns the argmax of the last
position's logits, the first index on ties, as runtime/sampling.sample.

``params`` is the JAX package's tree with torch tensors: wte [V, D], wpe
[S, D] (learned positions), ln_f {g, b}, and ``layers`` a list of {ln_1,
ln_2, w_qkv, b_qkv, wo, bo, w_fc, b_fc, w_proj, b_proj}.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from zgml_tpu_torch.models.llama import write_kv
from zgml_tpu_torch.ops import dispatch as ops
from zgml_tpu_torch.ops import refs
from zgml_tpu_torch.quant.packed import resolve_device


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int
    d_model: int
    n_heads: int
    n_layers: int
    max_seq_len: int = 1024
    d_ff: int | None = None          # default 4 * d_model
    layer_norm_eps: float = 1e-5
    learned_pos: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def ff(self) -> int:
        return self.d_ff or 4 * self.d_model


def sinusoidal_positions(max_seq: int, d: int) -> np.ndarray:
    """The sinusoidal position table [max_seq, d] f32, computed as
    zgml_tpu/models/gpt.py:43-51 computes it (numpy float64, then f32)."""
    pos = np.arange(max_seq)[:, None]
    i = np.arange(d)[None, :]
    angle = pos / np.power(10000.0, (2 * (i // 2)) / d)
    out = np.zeros((max_seq, d), np.float32)
    out[:, 0::2] = np.sin(angle[:, 0::2])
    out[:, 1::2] = np.cos(angle[:, 1::2])
    return out


def gelu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu's default (tanh) form."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def init_params(cfg: GPTConfig, seed: int = 0, device="cuda", scale: float = 0.02) -> dict:
    """Random params drawn as zgml_tpu/models/gpt.py:54-84 draws them (numpy
    default_rng(seed), the same order and shapes: wte, each layer's w_qkv,
    wo, w_fc, w_proj, then wpe), so both packages build the same model from
    one seed. On the card unless device="cpu"."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    d, f = cfg.d_model, cfg.ff

    def w(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale).to(dev)

    def zeros(n):
        return torch.zeros(n, dtype=torch.float32, device=dev)

    def ln():
        return {"g": torch.ones(d, dtype=torch.float32, device=dev), "b": zeros(d)}

    params = {"wte": w(cfg.vocab_size, d), "ln_f": ln(), "layers": []}
    for _ in range(cfg.n_layers):
        params["layers"].append({"ln_1": ln(), "ln_2": ln(),
                                 "w_qkv": w(d, 3 * d), "b_qkv": zeros(3 * d),
                                 "wo": w(d, d), "bo": zeros(d),
                                 "w_fc": w(d, f), "b_fc": zeros(f),
                                 "w_proj": w(f, d), "b_proj": zeros(d)})
    if cfg.learned_pos:
        params["wpe"] = w(cfg.max_seq_len, d)
    return params


class GPTModel(torch.nn.Module):
    """Holds the config and the params dict; ``forward`` runs tokens through
    the stack against a cache from ``init_cache``, writing it in place."""

    def __init__(self, cfg: GPTConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.params = params
        self._sin_pos = None if cfg.learned_pos else torch.from_numpy(
            sinusoidal_positions(cfg.max_seq_len, cfg.d_model)).to(self.device)

    @property
    def device(self) -> torch.device:
        return self.params["wte"].device

    def init_cache(self, batch: int, dtype: str = "bf16") -> dict:
        """The stacked KV cache {"k", "v"} [L, B, H, S, hd]: "bf16", or "f32"
        (the JAX engine's cache_dtype=float32: prefill through K3's f32-K/V
        forms, decode through K4's f32 form)."""
        dt = {"bf16": torch.bfloat16, "f32": torch.float32}.get(dtype)
        if dt is None:
            raise ValueError(f"cache dtype {dtype!r}: want 'bf16' or 'f32'")
        c = self.cfg
        shape = (c.n_layers, batch, c.n_heads, c.max_seq_len, c.head_dim)
        return {"k": torch.zeros(shape, dtype=dt, device=self.device),
                "v": torch.zeros(shape, dtype=dt, device=self.device)}

    def body(self, tokens: torch.Tensor, cache: dict, pos: int) -> torch.Tensor:
        """tokens int [B, T] at positions pos.. -> hidden states f32 [B, T, D]
        before the final LayerNorm (zgml_tpu/models/gpt.py:101-142). Writes
        K/V of positions pos..pos+T-1 into `cache`; attention sees kv_len =
        pos + T."""
        cfg = self.cfg
        b, t = tokens.shape
        h, hd = cfg.n_heads, cfg.head_dim
        ck, cv = cache["k"], cache["v"]
        n_layers, rows = ck.shape[:2]
        if rows != b:
            raise ValueError(f"cache batch {rows}, tokens batch {b}")
        if pos + t > ck.shape[3]:
            raise ValueError(f"SequenceTooLong: pos {pos} + {t} tokens > {ck.shape[3]}")
        p = self.params
        positions = torch.arange(pos, pos + t, device=tokens.device)
        table = p["wpe"] if cfg.learned_pos else self._sin_pos
        x = p["wte"][tokens] + table[positions]
        decode = t == 1
        kv_len = torch.full((b,), pos + t, dtype=torch.int32, device=x.device) if decode \
            else pos + t
        rows_k = ck.view(n_layers * b, *ck.shape[2:])
        rows_v = cv.view(n_layers * b, *cv.shape[2:])
        for li, layer in enumerate(p["layers"]):
            hn = refs.layernorm_ref(x, layer["ln_1"]["g"], layer["ln_1"]["b"], cfg.layer_norm_eps)
            qkv = ops.qmatmul(hn, layer["w_qkv"]) + layer["b_qkv"]
            q, k, v = (u.reshape(b, t, h, hd).transpose(1, 2) for u in qkv.split(h * hd, dim=-1))
            write_kv(ck, cv, li, pos, k, v)
            if decode:
                att = ops.decode_attention(q.contiguous(), rows_k, rows_v, kv_len, kv_row=li * b)
            else:
                att = ops.flash_attention(q.contiguous(), rows_k, rows_v, kv_len=kv_len,
                                          q_offset=pos, kv_row=li * b)
            att = att.transpose(1, 2).reshape(b, t, h * hd)
            x = x + ops.qmatmul(att, layer["wo"]) + layer["bo"]
            hn = refs.layernorm_ref(x, layer["ln_2"]["g"], layer["ln_2"]["b"], cfg.layer_norm_eps)
            ff = gelu(ops.qmatmul(hn, layer["w_fc"]) + layer["b_fc"])
            x = x + ops.qmatmul(ff, layer["w_proj"]) + layer["b_proj"]
        return x

    def head(self, x: torch.Tensor, greedy: bool = False,
             tier_rows: int | None = None) -> torch.Tensor:
        """Final LayerNorm + the head tied to wte: logits f32 [B, T, V], or
        with greedy the argmax ids int64 [B] of the last position.
        tier_rows is the engine's (the row count a prefill head stands for);
        the tied head is one torch product at any count."""
        del tier_rows
        ln_f = self.params["ln_f"]
        x = refs.layernorm_ref(x, ln_f["g"], ln_f["b"], self.cfg.layer_norm_eps)
        logits = x.to(torch.float32) @ self.params["wte"].to(torch.float32).T
        if greedy:
            return torch.argmax(logits[:, -1], dim=-1)
        return logits

    def forward(self, tokens: torch.Tensor, cache: dict, pos: int = 0,
                greedy_head: bool = False) -> torch.Tensor:
        """tokens [B, T] -> logits [B, T, V] (or the next ids [B] with
        greedy_head); updates `cache` in place."""
        return self.head(self.body(tokens, cache, pos), greedy=greedy_head)
