"""Whisper-style encoder-decoder.

Counterpart of zgml_tpu/models/whisper.py: two GeLU convolutions over the
log-mel frames (stride 1, then stride 2, both with XLA's "SAME" padding),
sinusoidal (or the checkpoint's) encoder positions, a non-causal pre-LN
encoder; a decoder with causal self-attention, cross-attention over the
encoder states and a head tied to the token embedding. ``encode_features``,
the uncached ``decode`` (the oracle) and the cached ``decode_step`` /
``transcribe_greedy`` are the JAX model's.

Kernels on the path, as the JAX model's: the encoder and the uncached decoder
attend with the plain attention (``refs.attention_ref``), as JAX does
(whisper.py:83-92); ``decode_step`` runs K4 twice a layer through
``dispatch.decode_attention``, over the f32 self-attention cache and over the
f32 cross-attention K / V: its f32 form (``decode_attention_f32``), since
JAX's kernel widens whatever it is given and rounding to bf16 first would be
another function. The projections, convolutions, LayerNorms and GeLUs are
plain torch, as the JAX package leaves them to XLA. A convolution is one
matmul over the three taps of its padded input (torch.matmul is f32 unless a
caller turns TF32 on; cuDNN's convolutions take TF32 by default).

Layouts: the self cache is stacked {"k", "v"} f32 [L, B, H, n_text_ctx, hd],
read through kv_row = li * B; the cross K / V is a list of (k, v) per decoder
layer, each contiguous f32 [B, H, Ta, hd]. ``params`` is the JAX package's
tree with torch tensors, except the convolution weights, which are torch's
(and HF's) [out, in, k] where JAX holds "WIO" [k, in, out]
(io/llama_loader.whisper_params_from_jax turns one into the other).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from zgml_tpu_torch.models.gpt import gelu, sinusoidal_positions
from zgml_tpu_torch.ops import dispatch as ops
from zgml_tpu_torch.ops import refs
from zgml_tpu_torch.quant.packed import resolve_device


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    n_mels: int = 80
    n_audio_ctx: int = 1500      # encoder positions after the stride-2 conv
    n_audio_state: int = 384
    n_audio_heads: int = 6
    n_audio_layers: int = 4
    vocab_size: int = 51865
    n_text_ctx: int = 448
    n_text_state: int = 384
    n_text_heads: int = 6
    n_text_layers: int = 4
    eps: float = 1e-5

    @property
    def audio_head_dim(self) -> int:
        return self.n_audio_state // self.n_audio_heads

    @property
    def text_head_dim(self) -> int:
        return self.n_text_state // self.n_text_heads


def init_params(cfg: WhisperConfig, seed: int = 0, device="cuda", scale: float = 0.02) -> dict:
    """Random params drawn as zgml_tpu/models/whisper.py:51-80 draws them
    (numpy default_rng(seed), the same order: the encoder layers, the
    decoder layers, then conv1, conv2, tok_embd, pos_embd), the convolution
    weights turned to [out, in, k]. On the card unless device="cpu"."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    da, dt = cfg.n_audio_state, cfg.n_text_state

    def w(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale).to(dev)

    def zeros(n):
        return torch.zeros(n, dtype=torch.float32, device=dev)

    def ln(d):
        return {"g": torch.ones(d, dtype=torch.float32, device=dev), "b": zeros(d)}

    def attn(d):
        return {"wq": w(d, d), "bq": zeros(d), "wk": w(d, d), "wv": w(d, d), "bv": zeros(d),
                "wo": w(d, d), "bo": zeros(d)}

    def ffn(d):
        return {"w_fc": w(d, 4 * d), "b_fc": zeros(4 * d), "w_proj": w(4 * d, d),
                "b_proj": zeros(d)}

    enc = [{"ln_1": ln(da), "attn": attn(da), "ln_2": ln(da), **ffn(da)}
           for _ in range(cfg.n_audio_layers)]
    dec = [{"ln_1": ln(dt), "attn": attn(dt), "ln_x": ln(dt), "cross": attn(dt), "ln_2": ln(dt),
            **ffn(dt)} for _ in range(cfg.n_text_layers)]
    return {"conv1_w": w(3, cfg.n_mels, da).permute(2, 1, 0).contiguous(), "conv1_b": zeros(da),
            "conv2_w": w(3, da, da).permute(2, 1, 0).contiguous(), "conv2_b": zeros(da),
            "enc_ln_post": ln(da), "enc_layers": enc,
            "tok_embd": w(cfg.vocab_size, dt), "pos_embd": w(cfg.n_text_ctx, dt),
            "dec_ln": ln(dt), "dec_layers": dec}


def conv1d_same(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int) -> torch.Tensor:
    """XLA's "SAME" 1-D convolution (NWC in and out): x f32 [B, T, Cin], w
    [Cout, Cin, k], b [Cout] -> [B, ceil(T / stride), Cout]. SAME pads
    total = max((ceil(T / s) - 1) * s + k - T, 0) frames, total // 2 before
    and the rest after (F.conv1d's padding="same" refuses a stride of 2).
    Computed as one matmul over the k taps of the padded frames."""
    bsz, t, cin = x.shape
    cout, _, k = w.shape
    t_out = -(-t // stride)
    total = max((t_out - 1) * stride + k - t, 0)
    xp = torch.nn.functional.pad(x, (0, 0, total // 2, total - total // 2))
    span = (t_out - 1) * stride + 1
    taps = torch.stack([xp[:, j:j + span:stride] for j in range(k)], dim=2)  # [B, T', k, Cin]
    wk = w.permute(2, 1, 0).reshape(k * cin, cout)                             # WIO, flattened
    return taps.reshape(bsz, t_out, k * cin) @ wk + b


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, T, D] -> [B, H, T, D / H]."""
    b, t, d = x.shape
    return x.reshape(b, t, heads, d // heads).transpose(1, 2)


def _mha(p: dict, x_q: torch.Tensor, x_kv: torch.Tensor, heads: int,
         causal: bool = False) -> torch.Tensor:
    """The plain multi-head attention of zgml_tpu/models/whisper.py:83-92."""
    b, tq, d = x_q.shape
    q = _heads(x_q @ p["wq"] + p["bq"], heads)
    k = _heads(x_kv @ p["wk"], heads)
    v = _heads(x_kv @ p["wv"] + p["bv"], heads)
    mask = refs.causal_mask(tq, k.shape[2], device=x_q.device)[None, None] if causal else None
    att = refs.attention_ref(q, k, v, mask)
    return att.transpose(1, 2).reshape(b, tq, d) @ p["wo"] + p["bo"]


def _ffn_residual(lyr: dict, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """x + gelu(h W_fc + b_fc) W_proj + b_proj, added in JAX's order."""
    return x + gelu(h @ lyr["w_fc"] + lyr["b_fc"]) @ lyr["w_proj"] + lyr["b_proj"]


class WhisperModel(torch.nn.Module):
    """Holds the config and the params dict."""

    def __init__(self, cfg: WhisperConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.params = params
        self._audio_pos = torch.from_numpy(
            sinusoidal_positions(cfg.n_audio_ctx, cfg.n_audio_state)).to(self.device)

    @property
    def device(self) -> torch.device:
        return self.params["tok_embd"].device

    def _ln(self, x: torch.Tensor, p: dict) -> torch.Tensor:
        return refs.layernorm_ref(x, p["g"], p["b"], self.cfg.eps)

    # -- the encoder -----------------------------------------------------------
    def encode_features(self, mel: torch.Tensor) -> torch.Tensor:
        """mel f32 [B, T_mel, n_mels] -> encoder states [B, ceil(T_mel / 2),
        d_audio] (whisper.py:102-129)."""
        cfg, p = self.cfg, self.params
        mel = torch.as_tensor(mel, dtype=torch.float32, device=self.device)
        x = gelu(conv1d_same(mel, p["conv1_w"], p["conv1_b"], 1))
        x = gelu(conv1d_same(x, p["conv2_w"], p["conv2_b"], 2))
        t = x.shape[1]
        # checkpoints carry the encoder positions; synthesized params use the table
        x = x + p.get("enc_pos_embd", self._audio_pos)[:t]
        for lyr in p["enc_layers"]:
            h = self._ln(x, lyr["ln_1"])
            x = x + _mha(lyr["attn"], h, h, cfg.n_audio_heads)
            x = _ffn_residual(lyr, x, self._ln(x, lyr["ln_2"]))
        return self._ln(x, p["enc_ln_post"])

    # -- the uncached decoder (the oracle) -----------------------------------
    def decode(self, tokens, enc_states: torch.Tensor) -> torch.Tensor:
        """tokens [B, T], enc_states [B, Ta, d] -> logits [B, T, vocab]; the
        whole sequence each call (whisper.py:132-152)."""
        cfg, p = self.cfg, self.params
        tokens = torch.as_tensor(tokens, dtype=torch.int64, device=self.device)
        t = tokens.shape[1]
        x = p["tok_embd"][tokens] + p["pos_embd"][:t]
        for lyr in p["dec_layers"]:
            h = self._ln(x, lyr["ln_1"])
            x = x + _mha(lyr["attn"], h, h, cfg.n_text_heads, causal=True)
            x = x + _mha(lyr["cross"], self._ln(x, lyr["ln_x"]), enc_states, cfg.n_text_heads)
            x = _ffn_residual(lyr, x, self._ln(x, lyr["ln_2"]))
        return self._ln(x, p["dec_ln"]) @ p["tok_embd"].T

    # -- cached decoding ---------------------------------------------------------
    def init_cache(self, batch: int) -> dict:
        """The self-attention cache, f32 as JAX's: {"k", "v"} [L, B, H,
        n_text_ctx, hd]."""
        c = self.cfg
        shape = (c.n_text_layers, batch, c.n_text_heads, c.n_text_ctx, c.text_head_dim)
        return {"k": torch.zeros(shape, dtype=torch.float32, device=self.device),
                "v": torch.zeros(shape, dtype=torch.float32, device=self.device)}

    def precompute_cross_kv(self, enc_states: torch.Tensor) -> list:
        """Per decoder layer (K, V) over the encoder states, each contiguous
        f32 [B, H, Ta, hd]: once an utterance (whisper.py:163-175)."""
        h = self.cfg.n_text_heads
        return [(_heads(enc_states @ lyr["cross"]["wk"], h).contiguous(),
                 _heads(enc_states @ lyr["cross"]["wv"] + lyr["cross"]["bv"], h).contiguous())
                for lyr in self.params["dec_layers"]]

    def decode_step(self, tokens, cross_kv: list, cache: dict, pos: int):
        """One cached step (whisper.py:177-224): tokens [B, 1] -> (logits
        [B, vocab], cache). The token's K / V are written into `cache` in
        place at `pos`; K4 attends over the cache prefix pos + 1 and over the
        cross K / V (decode_attention_f32 twice a layer)."""
        cfg, p = self.cfg, self.params
        tokens = torch.as_tensor(tokens, dtype=torch.int64, device=self.device)
        b = tokens.shape[0]
        h = cfg.n_text_heads
        ck, cv = cache["k"], cache["v"]
        n_layers, rows = ck.shape[:2]
        if rows != b or not 0 <= pos < ck.shape[3]:
            raise ValueError(f"cache of {rows} rows and {ck.shape[3]} positions, tokens batch "
                             f"{b} at pos {pos}")
        rows_k = ck.view(n_layers * b, *ck.shape[2:])
        rows_v = cv.view(n_layers * b, *cv.shape[2:])
        x = p["tok_embd"][tokens] + p["pos_embd"][pos:pos + 1]
        kv_len = torch.full((b,), pos + 1, dtype=torch.int32, device=x.device)
        for li, lyr in enumerate(p["dec_layers"]):
            a = lyr["attn"]
            hh = self._ln(x, lyr["ln_1"])
            q = _heads(hh @ a["wq"] + a["bq"], h)
            ck[li, :, :, pos:pos + 1] = _heads(hh @ a["wk"], h)
            cv[li, :, :, pos:pos + 1] = _heads(hh @ a["wv"] + a["bv"], h)
            att = ops.decode_attention(q.contiguous(), rows_k, rows_v, kv_len, kv_row=li * b)
            x = x + (att.transpose(1, 2).reshape(b, 1, -1) @ a["wo"] + a["bo"])
            c = lyr["cross"]
            qx = _heads(self._ln(x, lyr["ln_x"]) @ c["wq"] + c["bq"], h)
            ek, ev = cross_kv[li]
            xatt = ops.decode_attention(qx.contiguous(), ek, ev, ek.shape[2])
            x = x + (xatt.transpose(1, 2).reshape(b, 1, -1) @ c["wo"] + c["bo"])
            x = _ffn_residual(lyr, x, self._ln(x, lyr["ln_2"]))
        return (self._ln(x, p["dec_ln"]) @ p["tok_embd"].T)[:, 0], cache

    def transcribe_greedy(self, mel, bos: int, eos: int, max_tokens: int = 32) -> list[int]:
        """Greedy transcription of mel [1, T_mel, n_mels] on the cached path
        (whisper.py:226-240): bos, then up to max_tokens argmax ids (the first
        index on ties), cut after eos."""
        enc = self.encode_features(mel)
        cross_kv = self.precompute_cross_kv(enc)
        cache = self.init_cache(enc.shape[0])
        toks = [bos]
        for i in range(max_tokens):
            logits, cache = self.decode_step([[toks[-1]]], cross_kv, cache, i)
            toks.append(int(torch.argmax(logits[0])))
            if toks[-1] == eos:
                break
        return toks
