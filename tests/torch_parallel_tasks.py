"""Rank functions of the parallel tests: each runs on every rank of a
zgml_tpu_torch.parallel.world.World, as fn(device, *args), and returns
numpy results to the test process. This module imports no JAX: the spawned
ranks import it by name to find the function they are given."""
from __future__ import annotations

import numpy as np
import torch

from zgml_tpu_torch.io.llama_loader import load_llama, params_from_jax
from zgml_tpu_torch.models.llama import LlamaModel
from zgml_tpu_torch.parallel import (make_mesh, make_pp_forward, make_pp_train_step,
                                     make_sharded_forward, make_sharded_train_step,
                                     shard_llama_params, shard_pp_params)
from zgml_tpu_torch.parallel.pp import _choose_micro
from zgml_tpu_torch.parallel.ring import make_ring_attention
from zgml_tpu_torch.quant.packed import PackedWeight
from zgml_tpu_torch.runtime.engine import LlamaEngine
from zgml_tpu_torch.runtime.profile import global_profile
from zgml_tpu_torch.runtime.sampling import SamplingParams
from zgml_tpu_torch.runtime.serving import ContinuousBatchingEngine
from zgml_tpu_torch.utils.tree import paths


def build_model(src) -> LlamaModel:
    """("gguf", path[, mode]) or ("jax", cfg, numpy params of the JAX
    package) or ("zeros", cfg, kind): a model on the CPU."""
    if src[0] == "gguf":
        model, gf = load_llama(src[1], device="cpu", mode=src[2] if len(src) > 2 else "quantized")
        gf.close()
        return model
    if src[0] == "jax":
        return LlamaModel(src[1], params_from_jax(src[2], src[1], device="cpu"))
    cfg, kind = src[1], src[2]
    return LlamaModel(cfg, zero_params(cfg, kind))


def zero_params(cfg, kind: str) -> dict:
    """A model of the given widths whose packed weights are all level 0 with
    scale 1/64 (the tier decisions read shapes and kinds alone)."""
    d, hd = cfg.d_model, cfg.head_dim

    def pw(n, k):
        qs = (torch.full((n, k // 2), 0x99, dtype=torch.uint8) if kind == "q4_0"
              else torch.ones((n, k), dtype=torch.int8))
        return PackedWeight(n, k, qs, torch.full((n, k // 32), 1 / 64, dtype=torch.float16),
                            kind)
    g = torch.Generator().manual_seed(0)
    layers = [{"attn_norm": torch.ones(d), "ffn_norm": torch.ones(d),
               "wqkv": pw((cfg.n_heads + 2 * cfg.n_kv_heads) * hd, d),
               "wo": pw(d, cfg.n_heads * hd), "w_gate_up": pw(2 * cfg.d_ff, d),
               "w_down": pw(d, cfg.d_ff)} for _ in range(cfg.n_layers)]
    return {"tok_embd": torch.randn((cfg.vocab_size, d), generator=g) * 0.1,
            "out_norm": torch.ones(d), "layers": layers, "lm_head": pw(cfg.vocab_size, d)}


def counts() -> dict:
    return {f"{op}/{tier}": n for (op, tier), n in global_profile.op_tiers.items()}


def tp_forward(dev, src, tp: int, dp: int, tokens: np.ndarray, steps: np.ndarray) -> dict:
    """The TP forward of `tokens` [B, T] (this rank's dp rows of it) from
    pos 0, then one decode step of steps [B, 1] at pos T:
    {"prefill": logits [B/dp, T, V], "decode": [B/dp, 1, V], "counts",
    "dp": this rank's dp index}."""
    model = build_model(src)
    mesh = make_mesh(tp=tp, dp=dp, device=dev)
    shard_llama_params(model, mesh)
    fwd = make_sharded_forward(model, mesh)
    b = tokens.shape[0] // dp
    rows = slice(mesh.coords["dp"] * b, (mesh.coords["dp"] + 1) * b)
    cache = model.init_cache(b)
    out = {"dp": mesh.coords["dp"]}
    global_profile.reset()
    out["prefill"] = fwd(torch.as_tensor(tokens[rows]), cache, 0).numpy()
    out["prefill_counts"] = counts()
    global_profile.reset()
    out["decode"] = fwd(torch.as_tensor(steps[rows]), cache, tokens.shape[1]).numpy()
    out["counts"] = counts()
    return out


def unsharded_refused(dev, src, tp: int) -> str:
    """make_sharded_forward over params that were never sharded: the error."""
    model = build_model(src)
    mesh = make_mesh(tp=tp, device=dev)
    try:
        make_sharded_forward(model, mesh)
    except ValueError as e:
        return str(e)
    return ""


def ring(dev, q: np.ndarray, k: np.ndarray, v: np.ndarray, causal: bool) -> dict:
    """Ring attention over all ranks (axis 'cp'): this rank's block of
    positions of q / k / v [B, H, T, d] in, its block of the output out."""
    mesh = make_mesh(tp=torch.distributed.get_world_size(), axis_names=("dp", "cp"),
                     device=dev)
    cp, idx = mesh.shape["cp"], mesh.coords["cp"]
    t = q.shape[2] // cp
    blk = [torch.as_tensor(a[:, :, idx * t:(idx + 1) * t]) for a in (q, k, v)]
    global_profile.reset()
    out = make_ring_attention(mesh, axis="cp", causal=causal)(*blk)
    return {"out": out.numpy(), "counts": counts(), "hops": dict(global_profile.counters)}


def cp_prefill(dev, src, prompt: np.ndarray, cache_dtype: str) -> dict:
    """LlamaEngine.prefill_cp of `prompt` over all ranks, then one greedy
    decode step: {"last": logits [1, V], "cache": {name: first T positions},
    "step": logits [1, V]} (each rank returns its own)."""
    model = build_model(src)
    mesh = make_mesh(tp=torch.distributed.get_world_size(), axis_names=("dp", "cp"),
                     device=dev)
    eng = LlamaEngine(model, cache_dtype=cache_dtype)
    global_profile.reset()
    last = eng.prefill_cp(prompt, mesh)
    t = len(prompt)
    cache = {name: c[:, :, :, :t].float().numpy() for name, c in eng.cache.items()}
    _, step = eng.step(torch.argmax(last, dim=-1))
    return {"last": last.numpy(), "cache": cache, "step": step.numpy(), "counts": counts(),
            "hops": dict(global_profile.counters)}


def serve(dev, src, tp: int, dp: int, max_batch: int, requests, burst: int,
          sampling: SamplingParams = SamplingParams(), seed: int = 0) -> dict:
    """The requests [(prompt, n_new), ...] through a ContinuousBatchingEngine
    over a (dp, tp) mesh: {rid: tokens}."""
    model = build_model(src)
    mesh = make_mesh(tp=tp, dp=dp, device=dev)
    shard_llama_params(model, mesh)
    eng = ContinuousBatchingEngine(model, max_batch=max_batch, mesh=mesh, sampling=sampling,
                                   seed=seed)
    return eng.run([(list(p), n) for p, n in requests], burst=burst)


def tp_collectives(dev, x: np.ndarray) -> dict:
    """models/llama's _tp_copy, _tp_reduce and _tp_gather on a tp group of
    every rank, forward and backward: rank r feeds x * (r + 1) and weighs
    the output by (r + 1) in its loss."""
    from zgml_tpu_torch.models.llama import TPShard, _tp_copy, _tp_gather, _tp_reduce
    mesh = make_mesh(tp=torch.distributed.get_world_size(), device=dev)
    tp = TPShard(mesh.groups["tp"], mesh.shape["tp"], mesh.coords["tp"])
    w = float(tp.rank + 1)
    out = {}
    for name, fn in (("copy", _tp_copy), ("reduce", _tp_reduce), ("gather", _tp_gather)):
        a = torch.tensor(x * w, requires_grad=True)
        y = fn(a, tp)
        (y * w * torch.arange(1, y.shape[-1] + 1, dtype=y.dtype)).sum().backward()
        out[name] = (y.detach().numpy(), a.grad.numpy())
    return out


def _np_tree(params) -> dict:
    """{path: numpy} of a dense params tree (utils.tree.paths)."""
    return {p: t.detach().cpu().numpy() for p, t in paths(params)}


def tp_train(dev, src, tp: int, dp: int, tokens: np.ndarray, lr: float, steps: int) -> dict:
    """`steps` make_sharded_train_step steps of this rank's dp rows of
    tokens [B, T + 1] over a (dp, tp) mesh: {"losses", "grads" of the first
    step's loss_and_grads by path, "params" after the steps by path (the
    rank's shard), "dp", "tp", "counts" of the first step}."""
    model = build_model(src)
    mesh = make_mesh(tp=tp, dp=dp, device=dev)
    shard_llama_params(model, mesh)
    step = make_sharded_train_step(model, mesh)
    b = tokens.shape[0] // dp
    mine = torch.as_tensor(tokens[mesh.coords["dp"] * b:(mesh.coords["dp"] + 1) * b])
    global_profile.reset()
    _, grads = step.loss_and_grads(mine)
    names = [p for p, _ in paths(model.params)]
    out = {"dp": mesh.coords["dp"], "tp": mesh.coords["tp"], "counts": counts(),
           "grads": {n: g.numpy() for n, g in zip(names, grads)}, "losses": []}
    for _ in range(steps):
        loss, _ = step(mine, lr)
        out["losses"].append(float(loss))
    out["params"] = _np_tree(model.params)
    return out


def pp_train(dev, src, n_micro, tokens: np.ndarray, lr: float, steps: int) -> dict:
    """`steps` make_pp_train_step steps of tokens [B, T + 1] over a 'pp' axis
    of every rank: {"losses", "grads" of the first step by path (the stage's
    layers numbered from 0), "params" after the steps, "stage", "counts" and
    "ticks" (pp_stage_runs, pp_bubble_ticks) of the first step}."""
    model = build_model(src)
    mesh = make_mesh(tp=torch.distributed.get_world_size(), axis_names=("dp", "pp"), device=dev)
    shard_pp_params(model, mesh)
    step = make_pp_train_step(model, mesh, n_micro)
    global_profile.reset()
    _, grads = step.loss_and_grads(torch.as_tensor(tokens))
    names = [p for p, _ in paths(model.params)]
    out = {"stage": mesh.coords["pp"], "counts": counts(), "ticks": dict(global_profile.counters),
           "grads": {n: g.numpy() for n, g in zip(names, grads)}, "losses": []}
    for _ in range(steps):
        loss, _ = step(torch.as_tensor(tokens), lr)
        out["losses"].append(float(loss))
    out["params"] = _np_tree(model.params)
    return out


def pp_forward(dev, src, n_micro, tokens: np.ndarray, steps: np.ndarray,
               cache_dtype: str) -> dict:
    """make_pp_forward over a 'pp' axis of every rank: prefill of tokens [B,
    T] from pos 0, then one decode token steps [B, 1] at pos T: {"prefill",
    "decode" logits, "cache": the stage's slabs' first T + 1 positions,
    "stage", "counts" and "ticks" of the prefill}."""
    model = build_model(src)
    mesh = make_mesh(tp=torch.distributed.get_world_size(), axis_names=("dp", "pp"), device=dev)
    shard_pp_params(model, mesh)
    fwd = make_pp_forward(model, mesh, n_micro)
    cache = model.init_cache(tokens.shape[0], cache_dtype)
    global_profile.reset()
    out = {"stage": mesh.coords["pp"], "prefill": fwd(torch.as_tensor(tokens), cache, 0).numpy()}
    out["counts"], out["ticks"] = counts(), dict(global_profile.counters)
    out["decode"] = fwd(torch.as_tensor(steps), cache, tokens.shape[1]).numpy()
    out["cache"] = {n: c[:, :, :, :tokens.shape[1] + 1].float().numpy() for n, c in cache.items()}
    return out


def pp_refusals(dev, srcs: dict) -> dict:
    """The messages of the parallel training paths' refusals, each on the
    model of srcs[name]: "layers" (n_layers % pp), "unsharded" (params never
    split into stages), "batch" (batch % n_micro), "quantized" (a pipeline
    step of a quantized model) and "tp_quantized" (the sharded train step
    of one)."""
    mesh = make_mesh(tp=torch.distributed.get_world_size(), axis_names=("dp", "pp"), device=dev)
    tp_mesh = make_mesh(tp=2, device=dev)

    def batch(m):
        shard_pp_params(m, mesh)
        make_pp_forward(m, mesh, 3)(torch.zeros((4, 2), dtype=torch.long), m.init_cache(4), 0)

    def quantized(m):
        shard_pp_params(m, mesh)
        make_pp_train_step(m, mesh)

    def tp_quantized(m):
        shard_llama_params(m, tp_mesh)
        make_sharded_train_step(m, tp_mesh)(torch.zeros((4, 3), dtype=torch.long), 0.1)

    out = {}
    for name, fn, src in (("layers", lambda m: shard_pp_params(m, mesh), srcs["layers"]),
                          ("unsharded", lambda m: make_pp_forward(m, mesh), srcs["unsharded"]),
                          ("batch", batch, srcs["batch"]),
                          ("quantized", quantized, srcs["quantized"]),
                          ("tp_quantized", tp_quantized, srcs["tp_quantized"])):
        try:
            fn(build_model(src))
            out[name] = ""
        except ValueError as e:
            out[name] = str(e)
    return out
