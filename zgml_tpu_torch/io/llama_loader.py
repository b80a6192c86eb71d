"""GGUF -> LlamaModel (llama.cpp tensor names), and JAX params -> port params.

Counterpart of zgml_tpu/io/llama_loader.py, in its two modes
(`_load_matmul` / `_load_fused`, llama_loader.py:87-112):

  - mode="quantized" (the default): Q4_0 and Q8_0 matmul weights stay packed
    (quant/packed.py), fused along the out axis into wqkv (q|k|v) and
    w_gate_up (gate|up) so each is one launch; F16 / F32 ones load dense, as
    JAX loads them. A group whose tensors are of different types (real GGUFs
    often keep attn_v or ffn_up at Q8_0 inside a Q4_0 model) loads unfused,
    as wq / wk / wv or w_gate / w_up, exactly where JAX's `_load_fused`
    returns None;
  - mode="dense": every matmul weight f32 K-major [K, N] (Q4_0 / Q8_0
    dequantized, F16 / F32 as stored), wqkv and w_gate_up concatenated along
    N; the model computes their products with torch.matmul, as the JAX
    package computes them outside any Pallas kernel.

Norms and embeddings load as f32. Everything lands on the card unless the
caller asks for the CPU (device="cpu": the plain torch versions).
`quantize_llama_params` turns a dense model's matmul weights into packed ones
afterwards (JAX's post-hoc quantize, llama_loader.py:202-253). Weight types
the JAX package cannot decode either (K-quants) raise NotImplementedError.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from zgml_tpu_torch.io.gguf import GGMLType, GGUFFile
from zgml_tpu_torch.models.llama import LlamaConfig, LlamaModel
from zgml_tpu_torch.quant import blocks, packed
from zgml_tpu_torch.quant.packed import PackedWeight, resolve_device

_KINDS = {GGMLType.Q4_0: "q4_0", GGMLType.Q8_0: "q8_0"}
_DENSE_TYPES = (GGMLType.F32, GGMLType.F16)
_FROM_GGUF = {"q4_0": packed.from_gguf_q4_0, "q8_0": packed.from_gguf_q8_0}
MODES = ("quantized", "dense")


def config_from_gguf(gf: GGUFFile) -> LlamaConfig:
    md = gf.metadata
    arch = md.get("general.architecture", "llama")

    def get(key, default=None):
        return md.get(f"{arch}.{key}", default)

    n_heads = int(get("attention.head_count", 32))
    d_model = int(get("embedding_length", 4096))
    vocab = md.get("tokenizer.ggml.tokens")
    vocab_size = (len(vocab) if vocab is not None
                  else int(gf.tensors["token_embd.weight"].np_shape[0]))
    return LlamaConfig(
        vocab_size=vocab_size,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=int(get("attention.head_count_kv", n_heads)),
        d_ff=int(get("feed_forward_length", 4 * d_model)),
        n_layers=int(get("block_count", 32)),
        max_seq_len=int(get("context_length", 2048)),
        rope_base=float(get("rope.freq_base", 10000.0)),
        rms_norm_eps=float(get("attention.layer_norm_rms_epsilon", 1e-5)),
        tied_lm_head="output.weight" not in gf.tensors,
    )


def _kind(gf: GGUFFile, name: str) -> str:
    """q4_0 / q8_0, or "dense" for F16 / F32 (which both modes load dense)."""
    t = gf.tensors[name].ggml_type
    if t in _DENSE_TYPES:
        return "dense"
    if t not in _KINDS:
        raise NotImplementedError(
            f"{name} is {t.name}: zgml_tpu_torch loads Q4_0, Q8_0, F16 and F32 matmul "
            f"weights, as the JAX package decodes them (ROADMAP.md queue A)")
    return _KINDS[t]


def _dense(gf: GGUFFile, name: str, device) -> torch.Tensor:
    """An [N, K] matmul weight as f32 K-major [K, N] (llama_loader.py:94-95).
    Q4_0 / Q8_0 blocks go to the device packed and are dequantized and
    transposed there: level * scale is exact in f32, so the values are the
    numpy codec's, without a host pass over the f32 weights."""
    kind = _kind(gf, name)
    if kind in _FROM_GGUF:
        n, k = gf.tensors[name].np_shape
        return _FROM_GGUF[kind](gf.tensor_raw(name), n, k, device).dequant().t().contiguous()
    return _f32(np.ascontiguousarray(gf.tensor_f32(name).T), device)


def _matmul(gf: GGUFFile, name: str, mode: str, device):
    kind = _kind(gf, name)
    if mode == "dense" or kind == "dense":
        return _dense(gf, name, device)
    n, k = gf.tensors[name].np_shape
    return _FROM_GGUF[kind](gf.tensor_raw(name), n, k, device)


def _group(gf: GGUFFile, keys: tuple[str, ...], names: list[str], fused_key: str, mode: str,
           device) -> dict:
    """Weights of one input: fused along the out axis under `fused_key`
    (packed.concat, or torch.cat of the dense [K, N] parts along N), or, in
    the quantized mode where the tensors' types differ, each under its own
    key (llama_loader.py:98-116, 143-168)."""
    parts = [_matmul(gf, nm, mode, device) for nm in names]
    if mode == "quantized" and len({gf.tensors[nm].ggml_type for nm in names}) > 1:
        return dict(zip(keys, parts))
    if isinstance(parts[0], PackedWeight):
        return {fused_key: packed.concat(parts)}
    return {fused_key: torch.cat(parts, dim=1)}


def quantize_weight(w: np.ndarray, kind: str, device="cuda") -> PackedWeight:
    """An f32 [n, k] weight -> PackedWeight of `kind`, through the GGUF block
    codecs (quant/blocks.py), which write the bytes the JAX package writes."""
    n, k = w.shape
    raw = {"q4_0": blocks.quantize_q4_0, "q8_0": blocks.quantize_q8_0}[kind](w)
    return _FROM_GGUF[kind](raw, n, k, device)


def _f32(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C")).to(device)


def load_llama(path: str, device="cuda", max_seq_len: int | None = None,
               mode: str = "quantized") -> tuple[LlamaModel, GGUFFile]:
    """Load a llama GGUF onto `device` (the card unless device="cpu"), its
    matmul weights packed (mode="quantized") or f32 [K, N] (mode="dense").
    Returns (model, the parsed file); the caller owns the file and closes it
    (the model holds copies)."""
    if mode not in MODES:
        raise ValueError(f"load mode {mode!r}: want one of {MODES}")
    device = resolve_device(device)
    gf = GGUFFile(path)
    try:
        cfg = config_from_gguf(gf)
        if max_seq_len is not None:
            cfg = dataclasses.replace(cfg, max_seq_len=max_seq_len)
        layers = []
        for i in range(cfg.n_layers):
            blk = f"blk.{i}."
            layers.append({
                "attn_norm": _f32(gf.tensor_f32(blk + "attn_norm.weight"), device),
                "ffn_norm": _f32(gf.tensor_f32(blk + "ffn_norm.weight"), device),
                **_group(gf, ("wq", "wk", "wv"),
                         [blk + f"attn_{p}.weight" for p in ("q", "k", "v")], "wqkv", mode,
                         device),
                "wo": _matmul(gf, blk + "attn_output.weight", mode, device),
                **_group(gf, ("w_gate", "w_up"),
                         [blk + f"ffn_{p}.weight" for p in ("gate", "up")], "w_gate_up", mode,
                         device),
                "w_down": _matmul(gf, blk + "ffn_down.weight", mode, device),
            })
        params = {"tok_embd": _f32(gf.tensor_f32("token_embd.weight"), device),
                  "out_norm": _f32(gf.tensor_f32("output_norm.weight"), device),
                  "layers": layers}
        if not cfg.tied_lm_head:
            params["lm_head"] = _matmul(gf, "output.weight", mode, device)
    except BaseException:
        gf.close()
        raise
    return LlamaModel(cfg, params), gf


MATMULS = ("wq", "wk", "wv", "wqkv", "wo", "w_gate", "w_up", "w_gate_up", "w_down")


def quantize_llama_params(params: dict, kind: str = "q8_0") -> dict:
    """Post-hoc weight quantization of a dense-loaded llama, as the JAX
    package's (llama_loader.py:202-253): every dense matmul weight [K, N]
    becomes a PackedWeight of `kind` (packed.quantize, on the weight's
    device, the bytes the GGUF codecs write), fused wqkv / w_gate_up stay
    fused, packed weights stay as they are, and norms and embeddings stay
    f32. A PackedWeight's blocks run along K within one output row, so
    quantizing a fused [K, N] weight whole gives the blocks of quantizing
    each section (JAX's gate and up) and concatenating them. Returns a NEW
    params dict (a per-layer list) sharing the untouched tensors. A megacall
    view is carried over as it is: one attaches only where every projection
    is packed already, and packed weights are not touched."""
    layers = params.get("layers")
    if not isinstance(layers, (list, tuple)):
        raise ValueError("quantize_llama_params expects a per-layer list of layers")

    def q(leaf):
        return leaf if isinstance(leaf, PackedWeight) else packed.quantize(leaf.t(), kind)

    out = dict(params)
    out["layers"] = [{k: q(v) if k in MATMULS else v for k, v in layer.items()}
                     for layer in layers]
    if "lm_head" in out:
        out["lm_head"] = q(out["lm_head"])
    return out


def _field(pw: Any, name: str):
    return pw[name] if isinstance(pw, dict) else getattr(pw, name)


_FROM_PLANAR = {"q4_0": packed.from_planar_q4_0, "q8_0": packed.from_planar_q8_0}


def _from_jax_packed(pw: Any, device, col0: int = 0, n: int | None = None) -> PackedWeight:
    kind = _field(pw, "kind")
    if kind not in _FROM_PLANAR:
        raise NotImplementedError(f"{kind} weights wait for their kernels (ROADMAP.md queue A)")
    return _FROM_PLANAR[kind](np.asarray(_field(pw, "qvals")), np.asarray(_field(pw, "scales")),
                              _field(pw, "n") if n is None else n, _field(pw, "k"), col0, device)


_DENSE = ("attn_norm", "ffn_norm", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def params_from_jax(np_params: dict, cfg: LlamaConfig, device="cuda") -> dict:
    """The JAX package's llama params -> this package's params on `device`
    (the card unless device="cpu").

    `np_params` is, with every array as numpy, either what zgml_tpu's
    load_llama or quantize_llama_params builds (unrolled layer list, Q4_0 or
    Q8_0 PackedWeights; a packed weight is any object or dict with kind, n,
    k, qvals, scales), or the dense tree of its init_params (``layers`` a dict
    of stacked [L, ...] f32 arrays, split here into the per-layer list; the
    leaves stay f32 tensors a caller may mark requires_grad).

    A layer may hold unfused wq / wk / wv or w_gate / w_up (a mixed-kind
    GGUF), and dense leaves beside packed ones (F16 / F32 tensors). A packed
    w_gate_up is part-padded there: gate and up each fill half of its n
    columns (each padded to w_down's k_pad), so it is split at n // 2 and
    each half keeps its first d_ff columns. The padding columns hold zero
    scales and contribute nothing, so the result computes the same function.
    """
    device = resolve_device(device)
    if isinstance(np_params["layers"], dict):
        stacked = np_params["layers"]
        layers = [{n: _f32(stacked[n][li], device) for n in _DENSE}
                  for li in range(cfg.n_layers)]
    else:
        layers = [_from_jax_layer(lj, cfg, device) for lj in np_params["layers"]]
    params = {"tok_embd": _f32(np_params["tok_embd"], device),
              "out_norm": _f32(np_params["out_norm"], device),
              "layers": layers}
    head = np_params.get("lm_head")
    if head is not None:
        params["lm_head"] = (_f32(head, device) if isinstance(head, np.ndarray)
                             else _from_jax_packed(head, device))
    return params


def _from_jax_layer(lj: dict, cfg: LlamaConfig, device) -> dict:
    """One JAX layer: its norms and matmul weights, fused or unfused, packed
    or dense (numpy [K, N]); the derived views (wo3, ffn_q4n) are dropped."""
    out = {}
    for key, v in lj.items():
        if key in ("attn_norm", "ffn_norm") or (key in MATMULS and isinstance(v, np.ndarray)):
            out[key] = _f32(v, device)
        elif key == "w_gate_up":
            half = _field(v, "n") // 2
            out[key] = packed.concat([_from_jax_packed(v, device, 0, cfg.d_ff),
                                      _from_jax_packed(v, device, half, cfg.d_ff)])
        elif key in MATMULS:
            out[key] = _from_jax_packed(v, device)
    return out


def _tree_f32(tree, device):
    """A JAX params tree of numpy arrays (dicts and lists) as f32 tensors on `device`."""
    if isinstance(tree, dict):
        return {k: _tree_f32(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_f32(v, device) for v in tree]
    return _f32(tree, device)


def gpt_params_from_jax(np_params: dict, cfg, device="cuda") -> dict:
    """zgml_tpu/models/gpt.py's params (its init_params or load_gpt2_hf tree,
    every array as numpy) -> models/gpt.GPTModel's on `device` (the card
    unless device="cpu"): the same tree, f32 tensors."""
    if len(np_params["layers"]) != cfg.n_layers:
        raise ValueError(f"{len(np_params['layers'])} layers, cfg has {cfg.n_layers}")
    return _tree_f32(np_params, resolve_device(device))


def whisper_params_from_jax(np_params: dict, cfg, device="cuda") -> dict:
    """zgml_tpu/models/whisper.py's params (numpy) -> models/whisper.
    WhisperModel's on `device` (the card unless device="cpu"): the same tree
    of f32 tensors, the convolution weights turned from lax's "WIO" [k, in,
    out] to [out, in, k]."""
    if (len(np_params["enc_layers"]), len(np_params["dec_layers"])) != (
            cfg.n_audio_layers, cfg.n_text_layers):
        raise ValueError(f"{len(np_params['enc_layers'])} / {len(np_params['dec_layers'])} "
                         f"layers, cfg has {cfg.n_audio_layers} / {cfg.n_text_layers}")
    out = _tree_f32(np_params, resolve_device(device))
    for name in ("conv1_w", "conv2_w"):
        out[name] = out[name].permute(2, 1, 0).contiguous()
    return out
