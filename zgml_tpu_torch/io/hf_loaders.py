"""HuggingFace llama safetensors -> LlamaModel.

Counterpart of zgml_tpu/io/hf_loaders.py's load_llama_hf (:24-67): the HF
names (model.embed_tokens, model.layers.{i}.self_attn.{q,k,v,o}_proj,
mlp.{gate,up,down}_proj, input_layernorm, post_attention_layernorm,
model.norm, lm_head), each [out, in] weight turned K-major [in, out], q / k /
v and gate / up concatenated into wqkv and w_gate_up when `fuse` is set. The
model is dense f32, as JAX's; `LlamaModel.quantize` packs it. The GPT-2 and
Whisper loaders come with their models (ROADMAP.md A.6).
"""
from __future__ import annotations

import torch

from zgml_tpu_torch.io.safetensors import SafetensorsFile
from zgml_tpu_torch.models.llama import LlamaConfig, LlamaModel
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
