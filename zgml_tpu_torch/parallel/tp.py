"""Tensor + data parallel inference and training of the llama model on torch.distributed.

Counterpart of zgml_tpu/parallel/tp.py (55-546). The JAX
package runs Megatron-style TP inside shard_map over a 'tp' mesh axis; the
port runs one process per rank, each holding only its own shard:

  - wq / wk / wv (fused: wqkv's Q, K and V head rows), w_gate / w_up
    (fused: w_gate_up's gate and up halves): column-sharded, out-features
    local, no communication;
  - wo, w_down: row-sharded (in-features local), their outputs summed over
    the tp group (models/llama._tp_reduce);
  - the KV cache: sharded over KV heads (each rank's init_cache holds its
    heads, tp.py:375-378);
  - lm_head: vocab-sharded, the logits gathered over the tp group;
  - batch: sharded over 'dp' (each dp rank feeds its own rows).

The port's PackedWeight is N-major in GGUF block order (quant/packed.py), so
an 'n' shard is a slice of rows and a 'k' shard a slice of whole 32-blocks:
both exact, nothing re-padded or re-quantized. JAX re-derives each shard's
decode views on its local dict (shard_layer_fused, attach_head_major); the
port has no views to derive, and its path decisions (K7 and its A phase,
the K6 form, K1 or K2) are taken from the rank's local config and weights
(models/llama.local_config), where JAX takes them from the local dict.

torch has neither shard_map nor PartitionSpec, so llama_param_specs,
cache_specs and cache_specs_like have no counterpart: shard_llama_params
takes their role (ROADMAP.md, "Not ported, and why").

Training over the mesh (make_sharded_train_step, tp.py:510-546): each rank
differentiates the next-token loss of its dp rows through its shard; the
Megatron operators of models/llama.py give sharded leaves their exact local
gradients and replicated leaves the full gradient on every tp member, so
only the dp average is left, one all-reduce per flat bucket of gradients.
"""
from __future__ import annotations

import torch

from zgml_tpu_torch.models.llama import LlamaModel, TPShard, local_config
from zgml_tpu_torch.optim.sgd import sgd_update
from zgml_tpu_torch.parallel.mesh import Mesh, all_reduce, rank_device
from zgml_tpu_torch.quant.blocks import QK
from zgml_tpu_torch.quant.packed import QS_BLOCK_BYTES, PackedWeight
from zgml_tpu_torch.utils.tree import flatten

_COL_SHARDED = ("wq", "wk", "wv", "w_gate", "w_up")    # out-features over tp
_ROW_SHARDED = ("wo", "w_down")                        # in-features over tp


def _copy(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of a view, so the full tensor it views can be freed."""
    return t.clone(memory_format=torch.contiguous_format)


def shard_packed(pw: PackedWeight, tp: int, axis: str, index: int | None = None):
    """Shard `index` (or the list of all tp shards) of pw: axis 'n' splits
    the out-features (rows), 'k' the in-features (whole 32-blocks of each
    row). Raises where JAX's shard_packed raises: n or k not divisible by
    tp, a local K that is not a multiple of 32."""
    if axis == "n":
        if pw.n % tp:
            raise ValueError(f"n={pw.n} not divisible by tp={tp}")
        n = pw.n // tp

        def one(t):
            rows = slice(t * n, (t + 1) * n)
            return PackedWeight(n, pw.k, _copy(pw.qs[rows]), _copy(pw.d[rows]), pw.kind)
    elif axis == "k":
        if pw.k % tp:
            raise ValueError(f"k={pw.k} not divisible by tp={tp}")
        k = pw.k // tp
        if k % QK:
            raise ValueError(f"local K={k} not a multiple of {QK}")
        nb, bb = k // QK, QS_BLOCK_BYTES[pw.kind]

        def one(t):
            return PackedWeight(pw.n, k, _copy(pw.qs[:, t * nb * bb:(t + 1) * nb * bb]),
                                _copy(pw.d[:, t * nb:(t + 1) * nb]), pw.kind)
    else:
        raise ValueError(f"axis must be 'n' or 'k', got {axis!r}")
    return one(index) if index is not None else [one(t) for t in range(tp)]


def _take_rows(w, ranges):
    """The out-feature segments `ranges` [(start, length), ...] of w, joined:
    rows of a PackedWeight, columns of a dense [K, N] tensor."""
    if isinstance(w, PackedWeight):
        rows = torch.cat([torch.arange(s, s + n) for s, n in ranges]).to(w.qs.device)
        return PackedWeight(len(rows), w.k, w.qs[rows], w.d[rows], w.kind)
    return torch.cat([w[:, s:s + n] for s, n in ranges], dim=1)


def _split(w, tp: int, axis: str, t: int):
    """Shard t of a projection weight of either form: PackedWeight through
    shard_packed; a dense [K, N] tensor by columns ('n') or rows ('k')."""
    if isinstance(w, PackedWeight):
        return shard_packed(w, tp, axis, t)
    k, n = w.shape
    size = n if axis == "n" else k
    if size % tp:
        raise ValueError(f"{axis}={size} not divisible by tp={tp}")
    if axis == "n":
        return _copy(w[:, t * (n // tp):(t + 1) * (n // tp)])
    return _copy(w[t * (k // tp):(t + 1) * (k // tp)])


def shard_layer(layer: dict, cfg, tp: int, index: int) -> dict:
    """Rank `index`'s shard of one layer (JAX's shard_layer_fused,
    tp.py:185-312): its wqkv is its Q, K and V head rows, its w_gate_up its
    gate half and its up half, wo and w_down are split by K blocks, the norms
    are replicated; dense layers are sliced the same way, and a layer with
    unfused projections (wq / wk / wv, w_gate / w_up) has each split by its
    out-features (JAX's shard_llama_params)."""
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if hq % tp or hkv % tp:
        raise ValueError(f"heads {hq}/{hkv} not divisible by tp={tp}")
    hq_l, hkv_l = hq // tp, hkv // tp
    nq, nkv = hq * hd, hkv * hd
    out = {"attn_norm": layer["attn_norm"], "ffn_norm": layer["ffn_norm"]}
    for name, w in layer.items():
        if name == "wqkv":
            out[name] = _take_rows(w, [(index * hq_l * hd, hq_l * hd),
                                       (nq + index * hkv_l * hd, hkv_l * hd),
                                       (nq + nkv + index * hkv_l * hd, hkv_l * hd)])
        elif name == "w_gate_up":
            f = (w.n if isinstance(w, PackedWeight) else w.shape[1]) // 2
            if f % tp:
                raise ValueError(f"d_ff={f} not divisible by tp={tp}")
            f_l = f // tp
            out[name] = _take_rows(w, [(index * f_l, f_l), (f + index * f_l, f_l)])
        elif name in _COL_SHARDED:
            out[name] = _split(w, tp, "n", index)
        elif name in _ROW_SHARDED:
            out[name] = _split(w, tp, "k", index)
        elif name not in out:
            raise ValueError(f"shard_layer: no rule for layer tensor {name!r}")
    return out


def _to(w, dev: torch.device):
    if isinstance(w, PackedWeight):
        return PackedWeight(w.n, w.k, w.qs.to(dev), w.d.to(dev), w.kind)
    return w.to(dev)


def shard_llama_params(model: LlamaModel, mesh: Mesh, device=None) -> dict:
    """Replace model.params by this rank's shard over the mesh's 'tp' axis,
    on `device` (the mesh's, the card unless the mesh was made for the CPU)
    and set model.tp; the full weights are dropped layer by layer as their
    shards are made, so no rank holds a global copy. Every rank calls it
    with the same full params (each loads the checkpoint, device="cpu" to
    keep it off the card). The whole-stack decode views are dropped: the
    megacalls do not run under TP (llama.py:748). With tp 1 (a dp-only
    mesh) the params only move to the device. Returns the new params."""
    tp = int(mesh.shape.get("tp", 1))
    idx = mesh.coords.get("tp", 0)
    dev = mesh.device if device is None else rank_device(device)
    cfg, params = model.cfg, model.params
    if cfg.n_heads % tp or cfg.n_kv_heads % tp:
        raise ValueError(f"n_heads={cfg.n_heads}/n_kv_heads={cfg.n_kv_heads} "
                         f"not divisible by tp={tp}")
    layers = params["layers"]
    out = {"tok_embd": params["tok_embd"].to(dev), "out_norm": params["out_norm"].to(dev),
           "layers": []}
    for li, layer in enumerate(layers):
        loc = shard_layer(layer, cfg, tp, idx) if tp > 1 else layer
        out["layers"].append({name: _to(w, dev) for name, w in loc.items()})
        layers[li] = None
    lm = params.get("lm_head")
    if lm is not None:
        out["lm_head"] = _to(_split(lm, tp, "n", idx) if tp > 1 else lm, dev)
    model.params = out
    model.tp = (TPShard(mesh.groups["tp"], tp, idx, local_config(model.cfg, tp)) if tp > 1
                else None)
    return out


def _check_sharded(model: LlamaModel, tp: int):
    """Raise JAX's errors: heads not divisible by tp, and params that were
    never sharded."""
    cfg = model.cfg
    if cfg.n_heads % tp or cfg.n_kv_heads % tp:
        raise ValueError(f"n_heads={cfg.n_heads}/n_kv_heads={cfg.n_kv_heads} "
                         f"not divisible by tp={tp}")
    if tp > 1:
        la0 = model.params["layers"][0]
        w = la0.get("wqkv", la0.get("wq"))
        n = w.n if isinstance(w, PackedWeight) else w.shape[1]
        want = (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim // tp if "wqkv" in la0 else \
            cfg.n_heads * cfg.head_dim // tp
        if model.tp is None or model.tp.size != tp or n != want:
            raise ValueError("params not TP-sharded — run shard_llama_params(model, mesh) "
                             "first")


def make_sharded_forward(model: LlamaModel, mesh: Mesh):
    """fn(tokens, cache, pos) -> logits f32 [B, T, V] (full vocab) for this
    rank's dp rows `tokens` [B, T] and its cache (model.init_cache(B): the
    local KV heads), written in place at pos (tp.py:441-508). Raises JAX's
    errors: heads not divisible by tp, and params that were never sharded."""
    _check_sharded(model, int(mesh.shape.get("tp", 1)))

    @torch.inference_mode()
    def call(tokens: torch.Tensor, cache: dict, pos) -> torch.Tensor:
        return model(tokens.to(model.device), cache, pos)

    return call


GRAD_BUCKET_BYTES = 256 << 20     # gradients summed over dp in flat buckets of about this size


def next_token_nll(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The mean next-token negative log-likelihood of logits [B, T, V]
    against tokens [B, T + 1]'s last T columns (tp.py:519-524)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, tokens[:, 1:, None].to(logits.device)).mean()


def dense_leaves(params: dict, what: str) -> list[torch.Tensor]:
    """The leaves of a dense model's params (init_params), in flatten's
    order; a PackedWeight raises, as the JAX step does on a loaded quantized
    model (its gradient of int8 leaves)."""
    leaves, _ = flatten(params)
    if not all(isinstance(t, torch.Tensor) and t.is_floating_point() for t in leaves):
        raise ValueError(f"{what} trains dense float params (init_params), as the JAX "
                         f"package's: quantized weights have no gradient")
    return leaves


def dp_mean(loss: torch.Tensor, grads: list[torch.Tensor], group, dp: int):
    """pmean over the dp group of the loss and every gradient: the values
    packed into flat f32 buckets of about GRAD_BUCKET_BYTES, one all_reduce
    a bucket (under gloo each is two host copies, whatever its size), the
    sums divided by dp. Returns (loss, grads)."""
    if dp == 1:
        return loss, grads
    flat = [loss.reshape(1), *(g.reshape(-1) for g in grads)]
    out, bucket, size = [], [], 0
    for i, t in enumerate(flat):
        bucket.append(t)
        size += t.numel() * 4
        if size >= GRAD_BUCKET_BYTES or i == len(flat) - 1:
            summed = all_reduce(torch.cat(bucket), group) / dp
            out.extend(summed.split([u.numel() for u in bucket]))
            bucket, size = [], 0
    return out[0].reshape(()), [o.view_as(g) for o, g in zip(out[1:], grads)]


def stepper(model: LlamaModel, loss_and_grads):
    """fn(tokens, lr) -> (loss, new params): loss_and_grads(tokens), then an
    SGD step, which becomes model.params, so steps chain; fn.loss_and_grads
    is the first half alone."""
    def step(tokens: torch.Tensor, lr: float):
        loss, grads = loss_and_grads(tokens)
        model.params = sgd_update(model.params, flatten(model.params)[1](grads), lr)
        return loss, model.params

    step.loss_and_grads = loss_and_grads
    return step


def make_sharded_train_step(model: LlamaModel, mesh: Mesh, optimizer=None):
    """The full dp + tp training step (tp.py:510-546) as fn(tokens, lr) ->
    (loss, new params), for this rank's dp rows tokens [B, T + 1] of a dense
    model (init_params) whose params are this rank's shard
    (shard_llama_params, as make_sharded_forward): the next-token loss of
    tokens[:, :-1] against tokens[:, 1:] through the training forward (K10
    flash attention on the card), its gradients by autograd through the
    Megatron operators, the loss and every gradient averaged over dp
    (dp_mean), then an SGD step. `optimizer` is taken and ignored, as JAX's
    step ignores it (it always takes sgd_update, tp.py:539). model.params
    becomes the new params, so steps chain. After a step the replicated
    leaves are the same bits on every rank. fn.loss_and_grads(tokens) gives
    (loss, grads in flatten order) without the update."""
    tp, dp = int(mesh.shape.get("tp", 1)), int(mesh.shape.get("dp", 1))
    _check_sharded(model, tp)
    dp_group = mesh.groups.get("dp")

    def loss_and_grads(tokens: torch.Tensor):
        leaves = dense_leaves(model.params, "make_sharded_train_step")
        tokens = tokens.to(model.device)
        with torch.enable_grad():
            for t in leaves:
                t.requires_grad_(True)
            try:
                loss = next_token_nll(model(tokens[:, :-1]), tokens)
                grads = torch.autograd.grad(loss, leaves)
            finally:
                for t in leaves:
                    t.requires_grad_(False)
        return dp_mean(loss.detach(), list(grads), dp_group, dp)

    return stepper(model, loss_and_grads)
