"""HuggingFace safetensors -> LlamaModel, GPTModel, WhisperModel.

Counterpart of zgml_tpu/io/hf_loaders.py. load_llama_hf (:24-67): the HF
names (model.embed_tokens, model.layers.{i}.self_attn.{q,k,v,o}_proj,
mlp.{gate,up,down}_proj, input_layernorm, post_attention_layernorm,
model.norm, lm_head), each [out, in] weight turned K-major [in, out], q / k /
v and gate / up concatenated into wqkv and w_gate_up when `fuse` is set.
load_gpt2_hf (:70-103): GPT-2's Conv1D weights are stored [in, out] already.
load_whisper_hf (:106-200): q and v carry biases and k does not, the head
counts come from a config.json beside the file where there is one (else
d // 64), the convolutions stay HF's [out, in, k] (the port's layout). Every
model is dense f32 on `device` (the card unless device="cpu"): each tensor
goes there as stored (F16 / BF16 widened to f32 there, F32 as it is) and is
transposed there.
"""
from __future__ import annotations

import json
import os

import torch

from zgml_tpu_torch.io.safetensors import SafetensorsFile
from zgml_tpu_torch.models.gpt import GPTConfig, GPTModel
from zgml_tpu_torch.models.llama import LlamaConfig, LlamaModel
from zgml_tpu_torch.models.whisper import WhisperConfig, WhisperModel
from zgml_tpu_torch.quant.packed import resolve_device

_ATTN = (("wq", "self_attn.q_proj"), ("wk", "self_attn.k_proj"), ("wv", "self_attn.v_proj"))
_MLP = (("w_gate", "mlp.gate_proj"), ("w_up", "mlp.up_proj"))


def load_llama_hf(path: str, cfg: LlamaConfig, fuse: bool = True, prefix: str = "model.",
                  device="cuda") -> LlamaModel:
    """Load a llama-family HF safetensors file onto `device` (the card unless
    device="cpu"). cfg must match the checkpoint (config.json is not read).
    Each weight goes to the device as stored (F16 / BF16 widened to f32 there,
    F32 as it is) and is transposed there."""
    device = resolve_device(device)
    with SafetensorsFile(path) as st:
        def vec(name):
            return torch.from_numpy(st.tensor(prefix + name)).to(device, torch.float32)

        def mat(name):          # HF [out, in] -> K-major [in, out]
            w = torch.from_numpy(st.tensor(name)).to(device)
            return w.to(torch.float32).t().contiguous()

        layers = []
        for i in range(cfg.n_layers):
            p = f"{prefix}layers.{i}."
            layer = {"attn_norm": vec(f"layers.{i}.input_layernorm.weight"),
                     "ffn_norm": vec(f"layers.{i}.post_attention_layernorm.weight")}
            attn = {key: mat(p + hf + ".weight") for key, hf in _ATTN}
            layer.update({"wqkv": torch.cat(list(attn.values()), dim=1)} if fuse else attn)
            layer["wo"] = mat(p + "self_attn.o_proj.weight")
            mlp = {key: mat(p + hf + ".weight") for key, hf in _MLP}
            layer.update({"w_gate_up": torch.cat(list(mlp.values()), dim=1)} if fuse else mlp)
            layer["w_down"] = mat(p + "mlp.down_proj.weight")
            layers.append(layer)
        params = {"tok_embd": vec("embed_tokens.weight"), "out_norm": vec("norm.weight"),
                  "layers": layers}
        if not cfg.tied_lm_head:
            params["lm_head"] = mat("lm_head.weight")
    return LlamaModel(cfg, params)


def _reader(st: SafetensorsFile, device, prefix: str = ""):
    """(vec, mat) readers of `st` onto `device`: vec(name) as stored, f32;
    mat(name) an HF [out, in] weight turned [in, out]."""
    def vec(name):
        return torch.from_numpy(st.tensor(prefix + name)).to(device).to(torch.float32)

    def mat(name):
        return vec(name).t().contiguous()
    return vec, mat


def load_gpt2_hf(path: str, cfg: GPTConfig, prefix: str = "", device="cuda") -> GPTModel:
    """Load a GPT-2 HF safetensors file onto `device` (the card unless
    device="cpu"); cfg must match the checkpoint. Conv1D weights (c_attn,
    c_proj, c_fc) are [in, out] as stored."""
    device = resolve_device(device)
    with SafetensorsFile(path) as st:
        vec, _ = _reader(st, device, prefix)

        def ln(name):
            return {"g": vec(name + ".weight"), "b": vec(name + ".bias")}
        layers = []
        for i in range(cfg.n_layers):
            p = f"h.{i}."
            layers.append({"ln_1": ln(p + "ln_1"), "ln_2": ln(p + "ln_2"),
                           "w_qkv": vec(p + "attn.c_attn.weight"),
                           "b_qkv": vec(p + "attn.c_attn.bias"),
                           "wo": vec(p + "attn.c_proj.weight"), "bo": vec(p + "attn.c_proj.bias"),
                           "w_fc": vec(p + "mlp.c_fc.weight"), "b_fc": vec(p + "mlp.c_fc.bias"),
                           "w_proj": vec(p + "mlp.c_proj.weight"),
                           "b_proj": vec(p + "mlp.c_proj.bias")})
        params = {"wte": vec("wte.weight"), "wpe": vec("wpe.weight"), "ln_f": ln("ln_f"),
                  "layers": layers}
    return GPTModel(cfg, params)


def load_whisper_hf(path: str, cfg: WhisperConfig | None = None, device="cuda") -> WhisperModel:
    """Load an HF Whisper safetensors file onto `device` (the card unless
    device="cpu"). cfg None infers it from the tensor shapes, the head
    counts from config.json beside the file (encoder_attention_heads,
    decoder_attention_heads), else d // 64."""
    device = resolve_device(device)
    with SafetensorsFile(path) as st:
        vec, mat = _reader(st, device)
        names = set(st.keys())

        def ln(name):
            return {"g": vec(name + ".weight"), "b": vec(name + ".bias")}

        def attn(name):
            return {"wq": mat(name + ".q_proj.weight"), "bq": vec(name + ".q_proj.bias"),
                    "wk": mat(name + ".k_proj.weight"),
                    "wv": mat(name + ".v_proj.weight"), "bv": vec(name + ".v_proj.bias"),
                    "wo": mat(name + ".out_proj.weight"), "bo": vec(name + ".out_proj.bias")}

        def block(name, cross: bool):
            lyr = {"ln_1": ln(name + ".self_attn_layer_norm"), "attn": attn(name + ".self_attn"),
                   "ln_2": ln(name + ".final_layer_norm"),
                   "w_fc": mat(name + ".fc1.weight"), "b_fc": vec(name + ".fc1.bias"),
                   "w_proj": mat(name + ".fc2.weight"), "b_proj": vec(name + ".fc2.bias")}
            if cross:
                lyr["ln_x"] = ln(name + ".encoder_attn_layer_norm")
                lyr["cross"] = attn(name + ".encoder_attn")
            return lyr

        if cfg is None:
            def count(stack):
                return len({n.split(".")[3] for n in names if n.startswith(stack)})

            def shape(name):
                return st.entries[name]["shape"]
            d_model, n_mels, _ = shape("model.encoder.conv1.weight")
            heads_enc = heads_dec = max(1, d_model // 64)
            cfg_path = os.path.join(os.path.dirname(os.path.abspath(path)), "config.json")
            if os.path.exists(cfg_path):
                with open(cfg_path) as f:
                    hf = json.load(f)
                heads_enc = hf.get("encoder_attention_heads", heads_enc)
                heads_dec = hf.get("decoder_attention_heads", heads_dec)
            vocab, _ = shape("model.decoder.embed_tokens.weight")
            cfg = WhisperConfig(
                n_mels=n_mels, n_audio_ctx=shape("model.encoder.embed_positions.weight")[0],
                n_audio_state=d_model, n_audio_heads=heads_enc,
                n_audio_layers=count("model.encoder.layers."), vocab_size=vocab,
                n_text_ctx=shape("model.decoder.embed_positions.weight")[0],
                n_text_state=d_model, n_text_heads=heads_dec,
                n_text_layers=count("model.decoder.layers."))
        params = {"conv1_w": vec("model.encoder.conv1.weight"),
                  "conv1_b": vec("model.encoder.conv1.bias"),
                  "conv2_w": vec("model.encoder.conv2.weight"),
                  "conv2_b": vec("model.encoder.conv2.bias"),
                  "enc_pos_embd": vec("model.encoder.embed_positions.weight"),
                  "enc_ln_post": ln("model.encoder.layer_norm"),
                  "enc_layers": [block(f"model.encoder.layers.{i}", False)
                                 for i in range(cfg.n_audio_layers)],
                  "tok_embd": vec("model.decoder.embed_tokens.weight"),
                  "pos_embd": vec("model.decoder.embed_positions.weight"),
                  "dec_ln": ln("model.decoder.layer_norm"),
                  "dec_layers": [block(f"model.decoder.layers.{i}", True)
                                 for i in range(cfg.n_text_layers)]}
    return WhisperModel(cfg, params)
