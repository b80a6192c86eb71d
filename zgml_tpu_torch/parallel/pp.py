"""Pipeline parallelism: the llama layers split over a 'pp' mesh axis (GPipe).

Counterpart of zgml_tpu/parallel/pp.py (28-246). Stage s holds layers
[s * L / pp, (s + 1) * L / pp) and their KV-cache slabs; tok_embd, out_norm
and lm_head are replicated (``shard_pp_params``, the role of
pp_param_specs). The batch is cut into M microbatches, and the pipeline runs
M + pp - 1 ticks: at tick t stage s runs its layers on microbatch t - s
(and that microbatch's cache rows), then every stage hands its activation to
the next by ``mesh.ring_shift`` (JAX's ppermute ring, pp.py:160). The last
stage's outputs are broadcast to every stage, which is what JAX's masked
psum `_pp_collect` (pp.py:51-72) computes, and every stage applies the head
itself, so the logits are replicated.

JAX computes a clamped microbatch on bubble ticks and masks its writes
(pp.py:146-157); a stage here skips those ticks (the bits are the same),
counted under ``pp_bubble_ticks`` beside ``pp_stage_runs``, and still joins
every tick's ring shift, so all ranks make one sequence of collectives.

Training (``make_pp_train_step``): JAX differentiates through the tick scan
and gets the mirrored pipeline. One process per stage cannot leave the
collectives to autograd, whose order of nodes is each rank's own, while gloo
and NCCL pair collectives by order. So the backward is written out: each
tick's stage input is kept as a leaf; the head's loss backward gives the
replicated hidden states' cotangent, which goes to the last stage only (JAX's
`_pp_collect` backward); then per microbatch in reverse tick order each stage
runs autograd over its own layers from the cotangent of its output and sends
its input's gradient back by a reverse ring shift; stage 0's gradients of
the embedded rows are broadcast (JAX's `_pp_ingest` backward, a masked psum)
and every stage takes tok_embd's gradient from them. Every gradient is then
the one-process gradient's: layer leaves on their stage, the replicated
leaves on every stage as the same bits.

JAX's pipeline takes stacked dense layers (init_params) and refuses a loaded
quantized model (its scan and its gradient of int8 leaves); the port's takes
a dense model's per-layer list and raises on a PackedWeight, and a bf16 or
f32 cache (the int8 cache's tuples do not slice in JAX's pipeline either).
"""
from __future__ import annotations

import torch

from zgml_tpu_torch.models.llama import LlamaModel, _layer_step
from zgml_tpu_torch.ops import refs
from zgml_tpu_torch.parallel.mesh import Mesh, broadcast, rank_device, ring_shift
from zgml_tpu_torch.parallel.tp import _to, dense_leaves, next_token_nll, stepper
from zgml_tpu_torch.runtime.profile import global_profile


def _choose_micro(batch: int, pp: int) -> int:
    """The largest divisor of `batch` at most 4 * pp (pp.py:97-103: a bubble
    fraction of at most about 20%)."""
    best = 1
    for m in range(1, min(batch, 4 * pp) + 1):
        if batch % m == 0:
            best = m
    return best


def _stage(model: LlamaModel, mesh: Mesh) -> tuple[int, int, int]:
    """(pp, this rank's stage, layers a stage), raising as JAX does where
    n_layers % pp."""
    pp, n = int(mesh.shape["pp"]), model.cfg.n_layers
    if n % pp:
        raise ValueError(f"n_layers={n} not divisible by pp={pp}")
    return pp, int(mesh.coords["pp"]), n // pp


def shard_pp_params(model: LlamaModel, mesh: Mesh, device=None) -> dict:
    """Replace model.params by this rank's stage (pp_param_specs and
    shard_pp_params, pp.py:28-41, 240-246): its layers, and tok_embd,
    out_norm and lm_head replicated, on `device` (the mesh's where None).
    Every rank calls it with the same full params; the other stages' layers
    are dropped. model.init_cache then makes the stage's slabs. Returns the
    new params."""
    pp, s, per = _stage(model, mesh)
    dev = mesh.device if device is None else rank_device(device)
    params = model.params
    if len(params["layers"]) != model.cfg.n_layers:
        raise ValueError(f"params hold {len(params['layers'])} layers, the config "
                         f"{model.cfg.n_layers}: shard the full params once")
    out = {name: _to(params[name], dev) for name in ("tok_embd", "out_norm", "lm_head")
           if name in params}
    out["layers"] = [{k: _to(w, dev) for k, w in layer.items()}
                     for layer in params["layers"][s * per:(s + 1) * per]]
    model.params = out
    return out


def _check(model: LlamaModel, mesh: Mesh, what: str):
    pp, s, per = _stage(model, mesh)
    if len(model.params["layers"]) != per:
        raise ValueError(f"{what}: params hold {len(model.params['layers'])} layers, a stage "
                         f"{per} — run shard_pp_params(model, mesh) first")
    dense_leaves(model.params, what)
    return pp, s


def _micro(b: int, pp: int, n_micro: int | None) -> tuple[int, int]:
    m = n_micro or _choose_micro(b, pp)
    if b % m:
        raise ValueError(f"batch {b} not divisible by n_micro={m}")
    return m, b // m


def _ticks(pp: int, stage: int, m: int, reverse: bool = False):
    """The microbatch of each tick, or None on a bubble tick: the forward's
    microbatch t - stage, or the backward's, its mirror (the last stage
    starts on the last microbatch)."""
    for tk in range(m + pp - 1):
        mb = m - 1 - (tk - (pp - 1 - stage)) if reverse else tk - stage
        yield mb if 0 <= mb < m else None


def _gpipe(run, x: torch.Tensor, m: int, pp: int, stage: int, group) -> torch.Tensor:
    """The GPipe forward over M + pp - 1 ticks: on a tick with a microbatch
    the stage computes y = run(mb, rows, x_in) on stage 0's rows of x or the
    activation the previous stage sent, on a bubble tick nothing; every tick
    every stage sends its y (or what it holds) to the next. Returns the last
    stage's outputs [B, ...] on every stage (JAX's _pp_collect)."""
    mbs = x.shape[0] // m
    out = torch.zeros_like(x)
    act = torch.zeros_like(x[:mbs])
    for mb in _ticks(pp, stage, m):
        if mb is None:
            global_profile.add("pp_bubble_ticks")
            y = act
        else:
            global_profile.add("pp_stage_runs")
            rows = slice(mb * mbs, (mb + 1) * mbs)
            y = run(mb, rows, x[rows] if stage == 0 else act)
            if stage == pp - 1:
                out[rows] = y
        act = ring_shift([y], group)[0]
    return broadcast(out, group, pp - 1)


def make_pp_forward(model: LlamaModel, mesh: Mesh, n_micro: int | None = None):
    """The pipeline forward (pp.py:181-204) as fn(tokens, cache, pos) ->
    logits f32 [B, T, V], replicated on every stage, for tokens [B, T] (every
    stage the same) and the stage's cache (model.init_cache(B) after
    shard_pp_params), written in place at pos. n_micro defaults per call to
    _choose_micro(B, pp); B % n_micro raises. Prefill chunks take K3, decode
    tokens K4, on each stage's layers."""
    pp, stage = _check(model, mesh, "make_pp_forward")
    group, cfg = mesh.groups["pp"], model.cfg

    @torch.inference_mode()
    def call(tokens: torch.Tensor, cache: dict, pos: int) -> torch.Tensor:
        if "k_s" in cache:
            raise ValueError("the pipeline takes a bf16 or f32 cache, as JAX's (its int8 "
                             "cache's tuples do not slice)")
        tokens = tokens.to(model.device)
        b, t = tokens.shape
        m, mbs = _micro(b, pp, n_micro)
        ck, cv = cache["k"], cache["v"]
        if ck.shape[1] != b or pos + t > ck.shape[3]:
            raise ValueError(f"cache {tuple(ck.shape)} for batch {b} at pos {pos} + {t}")
        x = model.params["tok_embd"][tokens]
        cos, sin = refs.rope_cos_sin(torch.arange(pos, pos + t, device=x.device), cfg.head_dim,
                                     cfg.rope_base)
        decode = t == 1
        kv_len = (torch.full((mbs,), pos + t, dtype=torch.int32, device=x.device) if decode
                  else pos + t)

        def run(mb, rows, y):
            for li, layer in enumerate(model.params["layers"]):
                y = _layer_step(cfg, y, layer, ck, cv, li, pos, kv_len, cos, sin, decode,
                                row0=rows.start)
            return y
        return model.head(_gpipe(run, x, m, pp, stage, group))

    return call


def make_pp_train_step(model: LlamaModel, mesh: Mesh, n_micro: int | None = None):
    """The pipelined training step (pp.py:207-237) as fn(tokens, lr) ->
    (loss, new params) for tokens [B, T + 1] (every stage the same): the
    next-token loss of tokens[:, :-1] against tokens[:, 1:] through the GPipe
    forward on the training path (K10 flash attention on the card), the
    written-out GPipe backward (module note), then an SGD step (JAX's).
    model.params becomes the stage's new params.
    fn.loss_and_grads(tokens) gives (loss, grads in flatten order) without
    the update."""
    pp, stage = _check(model, mesh, "make_pp_train_step")
    group = mesh.groups["pp"]

    def loss_and_grads(tokens: torch.Tensor):
        tokens = tokens.to(model.device)
        b = tokens.shape[0]
        m, mbs = _micro(b, pp, n_micro)
        leaves = dense_leaves(model.params, "make_pp_train_step")
        with torch.enable_grad():
            for t in leaves:
                t.requires_grad_(True)
                t.grad = None
            try:
                x_emb = model.params["tok_embd"][tokens[:, :-1]]
                x = x_emb.detach()
                ins, outs = {}, {}      # each microbatch's stage input (a leaf) and output

                def run(mb, rows, x_in):
                    ins[mb] = x_in.detach().requires_grad_(True)
                    outs[mb] = model.train_layers(ins[mb])
                    return outs[mb].detach()
                final = _gpipe(run, x, m, pp, stage, group).requires_grad_(True)
                loss = next_token_nll(model.head(final), tokens)
                loss.backward()                              # the head's leaves, and final's
                g_final = final.grad
                g_emb = torch.zeros_like(x)
                g_back = torch.zeros_like(x[:mbs])
                for mb in _ticks(pp, stage, m, reverse=True):      # the mirrored pipeline
                    send = g_back
                    if mb is not None:
                        rows = slice(mb * mbs, (mb + 1) * mbs)
                        g_out = g_final[rows] if stage == pp - 1 else g_back
                        torch.autograd.backward(outs.pop(mb), g_out)
                        send = ins.pop(mb).grad
                        if stage == 0:
                            g_emb[rows] = send
                    g_back = ring_shift([send], group, reverse=True)[0]
                x_emb.backward(broadcast(g_emb, group, 0))   # tok_embd on every stage
                grads = [t.grad if t.grad is not None else torch.zeros_like(t) for t in leaves]
            finally:
                for t in leaves:
                    t.requires_grad_(False)
                    t.grad = None
        return loss.detach(), grads

    return stepper(model, loss_and_grads)
