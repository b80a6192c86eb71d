"""The port's packed checkpoint: a loaded llama's resident tensors in one
safetensors file, reloaded by an mmap and one copy to the device.

Counterpart of zgml_tpu/io/packed_ckpt.py. Loading a GGUF costs a parse and a
split of every block into the port's planes (quant/packed.py); this file keeps
the planes as they sit on the device, so a reload does no dequant and no
re-split: convert once with save_packed_llama, load fast with
load_packed_llama.

The file (written and read through io/safetensors.py):
  - every PackedWeight as its two planes, <name>.qs (uint8 [n, k/2] at Q4_0,
    int8 [n, k] at Q8_0) and <name>.d (float16 [n, k/32]), with its kind, n
    and k in the tree metadata ({"torch_packed": [kind, n, k]});
  - every dense leaf (norms, tok_embd, and in the dense load mode the f32
    [K, N] matmul weights) as it is;
  - the metadata keys `zgml_torch_layout` (LAYOUT, which marks the port's
    files), `zgml_config` (the LlamaConfig as JSON) and `zgml_tree` (the
    list lengths and the packed leaves' fields), as JAX's file keeps its
    config and tree.

Both load modes of io/llama_loader.load_llama (quantized and dense) round-trip.

The megacall views `layers_stacked` and `layers_tape` (ops/stackkernel.py
StackedLayers, ops/tapekernel.py Tape) are tables of pointers into the
resident weights and hold no bytes of their own: they are never written, and
the caller rebuilds them after loading with model.enable_stacked_decode() /
enable_tape_decode(), as after load_llama. (The JAX file persists its tape,
packed_ckpt.py:36-44 and 86-97, because building it costs minutes of host
transposes; the port's costs a table of pointers.)

A file the JAX package wrote holds the TPU planar layout (K-major qvals
[k_pad, n_pad], scales [k_pad/32, n_pad]; zgml_tree entries
"packed": [kind, n, k, n_pad, k_pad]) and lacks `zgml_torch_layout`:
load_packed_llama refuses it with a ValueError before reading any tensor.
"""
from __future__ import annotations

import dataclasses
import json
import warnings

import numpy as np
import torch

from zgml_tpu_torch.io.safetensors import SafetensorsFile, save_safetensors
from zgml_tpu_torch.models.llama import LlamaConfig, LlamaModel
from zgml_tpu_torch.quant.packed import PackedWeight, resolve_device

LAYOUT = "gguf-blocks-v1"      # N-major planes in GGUF block order (quant/packed.py)
VIEWS = ("layers_stacked", "layers_tape")   # pointer tables over the weights: not written


def _flatten(node, prefix: str, out: dict, tree: dict):
    if isinstance(node, PackedWeight):
        out[prefix + ".qs"] = node.qs.detach().cpu().numpy()
        out[prefix + ".d"] = node.d.detach().cpu().numpy()
        tree[prefix] = {"torch_packed": [node.kind, node.n, node.k]}
    elif isinstance(node, dict):
        for key, v in node.items():
            if key in VIEWS and not prefix:
                continue
            _flatten(v, f"{prefix}.{key}" if prefix else key, out, tree)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _flatten(v, f"{prefix}#{i}", out, tree)
        tree[prefix + "#len"] = len(node)
    elif isinstance(node, torch.Tensor):
        if node.dtype == torch.bfloat16:
            raise NotImplementedError(f"save_packed_llama: {prefix} is bfloat16, which the "
                                      f"port's safetensors writer does not take")
        out[prefix] = node.detach().cpu().numpy()
    else:
        raise TypeError(f"save_packed_llama: {prefix} is a {type(node).__name__}")


def save_packed_llama(path: str, model: LlamaModel):
    """Write `model`'s params (every PackedWeight's planes, the dense leaves)
    and config to one safetensors file at `path`; the megacall views are not
    written (see the module docstring)."""
    if model.tp is not None:
        raise ValueError("save_packed_llama: a tensor-parallel shard; save the whole model")
    tensors: dict[str, np.ndarray] = {}
    tree: dict = {}
    _flatten(model.params, "", tensors, tree)
    save_safetensors(path, tensors, metadata={
        "zgml_torch_layout": LAYOUT,
        "zgml_config": json.dumps(dataclasses.asdict(model.cfg)),
        "zgml_tree": json.dumps(tree),
    })


def _check_layout(st: SafetensorsFile, path: str):
    md = st.metadata
    layout = md.get("zgml_torch_layout")
    if layout == LAYOUT:
        return
    if layout is None and "zgml_tree" in md:
        tree = json.loads(md["zgml_tree"])
        if any(isinstance(v, dict) and ("packed" in v or "tape" in v) for v in tree.values()):
            raise ValueError(
                f"{path}: a packed checkpoint of the JAX package, in its TPU planar layout "
                f"(K-major qvals [k_pad, n_pad] and scales [k_pad/32, n_pad], zgml_tree "
                f"'packed': [kind, n, k, n_pad, k_pad]); the port reads its own layout "
                f"({LAYOUT!r}): load the GGUF with io.llama_loader.load_llama and write it "
                f"with save_packed_llama")
    raise ValueError(f"{path}: not a packed checkpoint of the port (metadata "
                     f"zgml_torch_layout {layout!r}, want {LAYOUT!r})")


def load_packed_llama(path: str, max_seq_len: int | None = None,
                      device="cuda") -> LlamaModel:
    """The model save_packed_llama wrote, on `device` (the card unless
    device="cpu"): each tensor an mmap view of the file copied once to the
    device, no dequant and no re-split. max_seq_len overrides the config's.
    Raises ValueError on a file the JAX package wrote (its TPU planar layout)
    or any other file without the port's layout key. The megacall views are
    the caller's to rebuild (enable_stacked_decode / enable_tape_decode)."""
    dev = resolve_device(device)
    with SafetensorsFile(path) as st:
        _check_layout(st, path)
        cfg = LlamaConfig(**json.loads(st.metadata["zgml_config"]))
        if max_seq_len is not None:
            cfg = dataclasses.replace(cfg, max_seq_len=max_seq_len)
        tree = json.loads(st.metadata["zgml_tree"])
        names = list(st.keys())

        def tensor(name: str) -> torch.Tensor:
            view = st.tensor(name, copy=False)
            with warnings.catch_warnings():     # a read-only mmap view: copied right here
                warnings.simplefilter("ignore", UserWarning)
                t = torch.from_numpy(view)
            return t.to(dev, copy=True)

        def build(prefix: str):
            node = tree.get(prefix)
            if isinstance(node, dict) and "torch_packed" in node:
                kind, n, k = node["torch_packed"]
                return PackedWeight(n, k, tensor(prefix + ".qs"), tensor(prefix + ".d"), kind)
            if prefix + "#len" in tree:
                return [build(f"{prefix}#{i}") for i in range(tree[prefix + "#len"])]
            pre = prefix + "." if prefix else ""
            kids = {nm[len(pre):].split(".")[0].split("#")[0]
                    for nm in (*names, *tree) if nm.startswith(pre) and nm != prefix}
            if not kids:
                return tensor(prefix)
            return {key: build(pre + key) for key in sorted(kids)}

        params = build("")
    return LlamaModel(cfg, params)
