"""The memory roofline of batch-1 decode: the rate the device's measured memory
bandwidth allows for a loaded model.

Counterpart of zgml_tpu/runtime/roofline.py. A batch-1 decode token streams
every weight the step reads plus the live KV prefix from device memory, so

    achievable tok/s = measured bandwidth / bytes a token

with the bandwidth measured on the card the model sits on (not the data
sheet's) and the bytes counted from the model as it is resident.
"""
from __future__ import annotations

import time

import torch

from zgml_tpu_torch.quant.packed import PackedWeight


def measure_hbm_bandwidth(nbytes: int = 1 << 30, iters: int = 192,
                          device="cuda") -> float:
    """Streaming bandwidth in bytes/s on `device` (the card unless named) by
    JAX's saxpy probe: y = y * 1.0000001 + 1e-12 over nbytes of f32, which
    reads and writes nbytes each pass (2x the traffic), `iters` passes
    between two torch.cuda.synchronize() barriers on that device, the best
    of two trials."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"measure_hbm_bandwidth: device {dev} is no card; a bandwidth is "
                         f"measured on the device the model sits on")
    y = torch.zeros(nbytes // 4, dtype=torch.float32, device=dev)
    b = torch.full((), 1e-12, dtype=torch.float32, device=dev)

    def trial() -> float:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(iters):      # one elementwise launch: y read once, written once
            torch.add(b, y, alpha=1.0000001, out=y)
        torch.cuda.synchronize(dev)
        return 2.0 * nbytes * iters / (time.perf_counter() - t0)
    trial()                                        # warm
    return max(trial(), trial())


def _leaf_bytes(leaf) -> int:
    if isinstance(leaf, PackedWeight):
        return leaf.qs.numel() * leaf.qs.element_size() + leaf.d.numel() * leaf.d.element_size()
    return leaf.numel() * leaf.element_size()


def weight_bytes_per_token(params: dict) -> int:
    """Bytes of weights a batch-1 decode token streams: every layer leaf in
    full (each PackedWeight's qs and d planes, dense matmul weights, the
    norms), the final norm, lm_head, and one tok_embd row, or the whole
    embedding where the head is tied to it (the logits read all of it).
    layers_stacked / layers_tape are pointer tables over the same weights
    and add nothing."""
    total = 0
    for layer in params["layers"]:
        for leaf in layer.values():
            total += _leaf_bytes(leaf)
    total += _leaf_bytes(params["out_norm"])
    embd = params["tok_embd"]
    if "lm_head" in params:
        total += _leaf_bytes(params["lm_head"]) + embd.shape[1] * embd.element_size()
    else:
        total += _leaf_bytes(embd)
    return total


_KV_ITEMSIZE = {"bf16": 2, "f32": 4}


def kv_bytes_per_token(cfg, kv_len: int, cache_dtype: str = "bf16") -> int:
    """KV bytes a decode step reads at a live prefix of kv_len positions, for
    the port's cache forms (LlamaModel.init_cache): "bf16", "f32", or "int8"
    (levels plus one f32 scale per position and KV head)."""
    elems = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * kv_len
    if cache_dtype == "int8":
        return elems + elems // cfg.head_dim * 4
    if cache_dtype not in _KV_ITEMSIZE:
        raise ValueError(f"cache dtype {cache_dtype!r}: want bf16, f32 or int8")
    return elems * _KV_ITEMSIZE[cache_dtype]


def roofline(model, kv_len: int, cache_dtype: str = "bf16",
             bandwidth: float | None = None) -> dict:
    """The achievable batch-1 decode rate of `model` at a live prefix of
    kv_len positions: bandwidth (measured on the model's card unless given)
    over the weight and KV bytes a token."""
    bw = bandwidth if bandwidth is not None else measure_hbm_bandwidth(device=model.device)
    wb = weight_bytes_per_token(model.params)
    kb = kv_bytes_per_token(model.cfg, kv_len, cache_dtype)
    per_tok = wb + kb
    return {"hbm_bandwidth_GBs": bw / 1e9, "weight_bytes": wb, "kv_bytes": kb,
            "bytes_per_token": per_tok, "achievable_tok_s": bw / per_tok}
