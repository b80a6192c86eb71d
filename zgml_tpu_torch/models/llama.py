"""Llama-family decoder over a stacked bf16 or int8 KV cache.

Counterpart of zgml_tpu/models/llama.py on the paths it runs over the
stacked cache, chosen as the JAX package chooses them (config.py flags):

  - batch-1 decode with ZGML_TPU_ATTN_BLOCK on (the default) and attn_block
    not switched off (config.kernel_on), a head_dim and weight kinds the
    layer kernel takes: per layer the fused attention
    block K7 (llama.py:773-811; its A phase int8 where ZGML_TPU_ATTN_I8A
    holds, by default at padded d >= 4096), then the fused FFN
    (`_ffn_after_attn`, llama.py:217-260: at Q4_0 K6c where ZGML_TPU_FFN_I8A
    holds, by default at padded d >= 4096, else K6d; K6a at Q8_0), or the
    composed FFN when fused_ffn is switched off or at a width JAX does not
    fuse at; under ZGML_TPU_LAYER_FFN=1 at Q4_0 (JAX's has_ffn) one launch of
    K7 with its phase E per layer instead, the FFN inside it;
  - everything else (prefill, batch > 1, ATTN_BLOCK=0): the per-layer
    `_layer_step` path (llama.py:286-341, 397-459) with fused `wqkv` and
    `w_gate_up` projections and K3/K4 attention (K9/K8 over the int8 cache,
    after the chunk's or token's K/V are quantized and written); its FFN,
    for calls of at most 32 rows where JAX fuses there, is JAX's composition at Q4_0
    (rmsnorm, the f32 fused FFN K6b, the residual; llama.py:326-340) and one
    K6a launch at Q8_0 (the same function), else composed;
  - `_head_out` (llama.py:517-543): greedy through K5 when it applies, else
    the argmax over the logits;
  - the opt-in whole-stack megacalls (llama.py:753-771): a batch-1 decode
    token over the bf16 cache runs ONE launch for all layers, K15 where
    ``enable_tape_decode()`` attached its view and ZGML_TPU_TAPE_DECODE is
    on, else K14 where ``enable_stacked_decode()`` attached its view and
    ZGML_TPU_STACK_DECODE is on (ZGML_TPU_KERNELS_DISABLE naming either
    turns it off); a view without its flag changes nothing, and prefill,
    batch > 1 and the int8 cache never reach them.

Every projection's tier (K1 int8 for M <= 32, or K2) is picked in
ops/dispatch.qmatmul, at the weight's kind (Q4_0 or Q8_0). GQA, RMSNorm,
half-split RoPE, SwiGLU, tied or separate lm_head.

Tensor parallelism (the JAX forward under shard_map with tp_axis,
llama.py:129-260, 353-512, 517-543, 695-854): once parallel/tp.
shard_llama_params has made the params a rank's shard and set ``tp``, every
rank runs these paths on its local heads and d_ff (``local_config``), the
collectives `_tp_copy` / `_tp_reduce` / `_tp_gather` (autograd Functions
with JAX's forward and backward) where JAX places them; the megacalls and
K7's phase E are off, K7 is chosen layer by layer (JAX's TP cache is the
per-layer list), and the head gathers the vocab-sharded logits, never K5.

The KV cache is stacked over layers and position-major in each of its
dtypes (``init_cache(batch, "bf16" | "f32" | "int8")``): ``{"k", "v"}`` bf16
or f32 tensors [L, B, Hkv, S, d] (over f32 prefill takes K3's f32-K/V
forms, batch-1 decode K7's f32-cache mode, other decode K4's f32 form), or
the int8 cache of quant/kv_cache.py, ``{"k", "k_s",
"v", "v_s"}`` int8 levels [L, B, Hkv, S, d] and f32 scales [L, B, Hkv, S].
``forward`` writes the new positions into it IN PLACE (the JAX package
threads a new cache value through instead). Attention reads layer li's slab
through the kernels' kv_row offset (the cache viewed as [L*B, Hkv, S, ...]),
without a copy. The JAX package keeps the bf16 cache stacked and the int8
one as a per-layer list (cache_layout, llama.py:651-654), and so picks K7
for all layers or none with the first and layer by layer with the second
(llama.py:343-357, 777-782); the port follows each.

Training (``forward(tokens)`` with no cache): the JAX forward from a fresh
``init_cache(B)`` at pos 0 (tests/test_training.py:156-160), which runs
`_layer_step` per layer. K and V are rounded to the cache's bf16 and handed
to flash attention as they are, without the cache write (in place under
autograd, layer 0's saved cache would be changed by layer 1); kv_len = T as
the fresh cache gives. Under autograd flash attention is K10, a quantized
projection K2 (or K1 at <= 32 rows) with K11 behind it, and an FFN call of
<= 32 rows the fused FFN (K6b, K6a's no-norm form at Q8_0) whose backward
recomputes gate|up at the projection tier and takes K11 (ops/ffn.FusedFFN);
ops/dispatch.py picks them.

``params`` is a plain dict, as in the JAX package: tok_embd/out_norm f32,
``layers`` a list of {attn_norm, ffn_norm, wqkv, wo, w_gate_up, w_down} with
PackedWeight or dense f32 [K, N] projections, where a layer of a mixed-kind
GGUF holds wq / wk / wv in place of wqkv and w_gate / w_up in place of
w_gate_up (``init_params`` and ``load_llama_hf(fuse=False)`` hold both unfused),
and lm_head (absent when tied; PackedWeight or dense [D, V]). A layer without
a packed wqkv and wo of one kind takes no K7: over the int8 cache JAX's
choice is made layer by layer, over the stacked bf16 cache for all layers or
none (llama.py:343-357, 775-782). ``quantize(kind)`` packs a dense model.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from zgml_tpu_torch import config
from zgml_tpu_torch.ops import dispatch as ops
from zgml_tpu_torch.ops import ffn, refs
from zgml_tpu_torch.ops.layerkernel import attn_block_compatible
from zgml_tpu_torch.ops.stackkernel import stack_llama_layers
from zgml_tpu_torch.ops.tapekernel import build_tape
from zgml_tpu_torch.quant import kv_cache
from zgml_tpu_torch.quant.packed import PackedWeight, resolve_device


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    n_layers: int
    max_seq_len: int = 2048
    rope_base: float = 10000.0
    rms_norm_eps: float = 1e-5
    tied_lm_head: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def n_rep(self) -> int:
        return self.n_heads // self.n_kv_heads


@dataclasses.dataclass(frozen=True)
class _LocalConfig(LlamaConfig):
    """A tensor-parallel rank's view of the config (JAX's _LocalCfgView,
    llama.py:205-214): its local head counts and d_ff with the FULL model
    width (norms see all of d; heads are the shard's own). head_dim is held
    explicitly: d_model / n_heads would be wrong for a shard."""
    local_head_dim: int = 0

    @property
    def head_dim(self) -> int:
        return self.local_head_dim


def local_config(cfg: LlamaConfig, tp: int) -> LlamaConfig:
    """The config a rank of a tp-way shard computes with."""
    return _LocalConfig(**{**dataclasses.asdict(cfg), "n_heads": cfg.n_heads // tp,
                           "n_kv_heads": cfg.n_kv_heads // tp, "d_ff": cfg.d_ff // tp},
                        local_head_dim=cfg.head_dim)


@dataclasses.dataclass(frozen=True)
class TPShard:
    """A rank's place in tensor parallelism: the process group of its tp
    axis, the axis size, its index there and the config its layers compute
    with (local_config; parallel/tp.py sets it once)."""
    group: object
    size: int
    rank: int
    cfg: LlamaConfig | None = None


class _TPCopy(torch.autograd.Function):
    """Megatron 'f' (llama.py:129-145): identity forward, psum backward, at
    the input of every column-parallel projection, so the replicated
    residual stream's cotangent stays replicated."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from zgml_tpu_torch.parallel.mesh import all_reduce
        return all_reduce(g, ctx.group), None


class _TPReduce(torch.autograd.Function):
    """Megatron 'g' (llama.py:148-178): psum forward, identity backward (a
    row-parallel projection's output joins the replicated stream)."""

    @staticmethod
    def forward(ctx, x, group):
        from zgml_tpu_torch.parallel.mesh import all_reduce
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _TPGather(torch.autograd.Function):
    """all_gather along the last axis, whose backward takes each rank's own
    slice of the replicated cotangent (llama.py:181-200)."""

    @staticmethod
    def forward(ctx, x, group, rank):
        from zgml_tpu_torch.parallel.mesh import all_gather
        ctx.slice = (rank * x.shape[-1], x.shape[-1])
        return all_gather(x, group, dim=-1)

    @staticmethod
    def backward(ctx, g):
        start, n = ctx.slice
        return g[..., start:start + n], None, None


def _tp_copy(x, tp: TPShard | None):
    return x if tp is None else _TPCopy.apply(x, tp.group)


def _tp_reduce(x, tp: TPShard | None):
    return x if tp is None else _TPReduce.apply(x, tp.group)


def _tp_gather(x, tp: TPShard | None):
    return x if tp is None else _TPGather.apply(x, tp.group, tp.rank)


def init_params(cfg: LlamaConfig, seed: int = 0, device="cuda", scale: float = 0.02) -> dict:
    """Random dense f32 params drawn as zgml_tpu/models/llama.py:93-121
    draws them (numpy default_rng(seed), the same order and shapes), so the
    two packages build the same model from one seed; the stacked [L, ...]
    leaves are split into the port's per-layer list. On the card unless
    device="cpu"."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv, f, L = cfg.n_heads * hd, cfg.n_kv_heads * hd, cfg.d_ff, cfg.n_layers

    def w(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale)

    def ones():
        return torch.ones(d, dtype=torch.float32, device=dev)

    params = {"tok_embd": w(cfg.vocab_size, d).to(dev), "out_norm": ones()}
    layers = [{"attn_norm": ones(), "ffn_norm": ones()} for _ in range(L)]
    for name, shape in (("wq", (d, nq)), ("wk", (d, nkv)), ("wv", (d, nkv)), ("wo", (nq, d)),
                        ("w_gate", (d, f)), ("w_up", (d, f)), ("w_down", (f, d))):
        stacked = w(L, *shape)
        for li in range(L):
            layers[li][name] = stacked[li].to(dev)
    params["layers"] = layers
    if not cfg.tied_lm_head:
        params["lm_head"] = w(d, cfg.vocab_size).to(dev)
    return params


def _qkv(cfg: LlamaConfig, h, layer: dict):
    """q [B, Hq, T, hd], k / v [B, Hkv, T, hd] (before RoPE): one fused
    projection (llama.py:400-408), or three dense ones (:409-412)."""
    b, t, _ = h.shape
    hd, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    nq, nkv = hq * hd, hkv * hd
    if "wqkv" in layer:
        qkv = ops.qmatmul(h, layer["wqkv"])
        q, k, v = qkv[..., :nq], qkv[..., nq:nq + nkv], qkv[..., nq + nkv:nq + 2 * nkv]
    else:
        q, k, v = (ops.qmatmul(h, layer[n]) for n in ("wq", "wk", "wv"))
    return (q.reshape(b, t, hq, hd).transpose(1, 2), k.reshape(b, t, hkv, hd).transpose(1, 2),
            v.reshape(b, t, hkv, hd).transpose(1, 2))


def write_kv(ck: torch.Tensor, cv: torch.Tensor, li: int, pos: int, k: torch.Tensor,
             v: torch.Tensor, wp: torch.Tensor | None = None, row0: int = 0):
    """k / v [B, Hkv, T, hd] into layer li of the bf16 or f32 cache, IN
    PLACE: at positions pos..pos+T-1 of rows row0..row0+B-1 (every row where
    B is the cache's; a batch-1 chunk into row row0, serving's prefill into a
    slot, zgml_tpu/models/llama.py:460-468; a pipeline microbatch's rows), or,
    wp an int32 tensor [B] and T 1, row b at position wp[b] (per-row decode,
    llama.py:474-478: indexed on the device, no host sync)."""
    t, b = k.shape[2], k.shape[0]
    for c, u in ((ck, k), (cv, v)):
        if wp is not None:
            rows = torch.arange(u.shape[0], device=wp.device)
            c[li][rows, :, wp.long()] = u[:, :, 0].to(c.dtype)
        else:
            c[li, row0:row0 + b, :, pos:pos + t] = u.to(c.dtype)


def _layer_step(cfg: LlamaConfig, x, layer: dict, ck, cv, li: int, pos: int, kv_len,
                cos, sin, decode: bool, wp: torch.Tensor | None = None,
                tp: TPShard | None = None, row0: int = 0):
    """One block. x f32 [B, T, D]; ck/cv the whole [L, B', Hkv, S, d] cache
    (bf16 or f32, or (levels, scales) tuples of the int8 one), written in
    place at (li, row0:row0+B, :, pos:pos+T): every row, or where the cache
    has more rows, a batch-1 chunk into a slot (serving) or a pipeline
    microbatch (parallel/pp.py), attended through kv_row li * B' + row0; or
    at (li, b, :, wp[b]) for per-row decode. decode: attention through the
    decode kernels with kv_len an int32 tensor [B]; otherwise flash over
    kv_len an int (prefill, and a slot's chunk at any length). ck None is
    training: pos 0, no cache, K/V rounded to bf16. Under tensor
    parallelism (tp, cfg the rank's local_config, layer its shard) the
    normed rows enter the column-parallel projections through _tp_copy and
    the outputs of wo and w_down are summed over the tp group before they
    join the stream (llama.py:398-512)."""
    b, t, _ = x.shape
    nq = cfg.n_heads * cfg.head_dim

    h = _tp_copy(ops.rmsnorm(x, layer["attn_norm"], cfg.rms_norm_eps), tp)
    q, k, v = _qkv(cfg, h, layer)
    q = ops.rope_apply(q, cos, sin)
    k = ops.rope_apply(k, cos, sin)
    if ck is None:
        # contiguous rows for the kernels: a cast of the transposed view keeps its strides
        kb, vb = (u.to(torch.bfloat16).contiguous() for u in (k, v))
        # the JAX forward attends over a cache of max_seq_len positions, whose
        # length sets the bf16 form's running-max step (ops/attention.flash_group)
        att = ops.flash_attention(q.contiguous(), kb, vb, kv_len=t, tile_s=cfg.max_seq_len)
    elif isinstance(ck, tuple):
        # the int8 cache (llama.py:424-459): quantize and write first, then
        # attend from the int8 rows like every other position
        L, bb = ck[0].shape[:2]
        kv_cache.write(ck, cv, li, pos, k, v, wp, row0)
        rows = [c.view(L * bb, *c.shape[2:]) for c in (*ck, *cv)]      # k, k_s, v, v_s
        if decode:
            att = ops.decode_attention_q8(q, *rows, kv_len, kv_row=li * bb + row0)
        else:
            att = ops.flash_attention_q8(q, *rows, kv_len=kv_len, q_offset=pos,
                                         kv_row=li * bb + row0)
    else:
        L, bb = ck.shape[:2]
        write_kv(ck, cv, li, pos, k, v, wp, row0)
        rows_k, rows_v = ck.view(L * bb, *ck.shape[2:]), cv.view(L * bb, *cv.shape[2:])
        if decode:
            att = ops.decode_attention(q, rows_k, rows_v, kv_len, kv_row=li * bb + row0)
        else:
            att = ops.flash_attention(q, rows_k, rows_v, kv_len=kv_len, q_offset=pos,
                                      kv_row=li * bb + row0)
    att = att.transpose(1, 2).reshape(b, t, nq)
    x = x + _tp_reduce(ops.qmatmul(att, layer["wo"]), tp)
    return _ffn(cfg, x, layer, after_attn_block=False, tp=tp)


def _phase_e(cfg: LlamaConfig, layer: dict) -> bool:
    """JAX's `has_ffn` (layerkernel.py:762-765): under ZGML_TPU_LAYER_FFN=1
    its K7 runs a Q4_0 layer's FFN as phase E, the f32 N-packed FFN, where
    the N-packed view exists (ffn_fuses after the layer kernel; its padded
    gate|up rows are then wqkv's k_pad)."""
    return (config.layer_ffn()
            and all(isinstance(layer.get(n), PackedWeight) and layer[n].kind == "q4_0"
                    for n in ("wqkv", "w_gate_up", "w_down"))
            and ffn.ffn_fuses(cfg.d_model, cfg.d_ff, "q4_0", after_attn_block=True))


def _ffn(cfg: LlamaConfig, x, layer: dict, after_attn_block: bool, tp: TPShard | None = None):
    """The FFN half of a layer, x + down(swiglu(gate|up(rmsnorm(x)))), fused
    where the JAX package fuses it (at most 32 rows, fused_ffn not disabled,
    a width and kind it fuses at: ops/ffn.ffn_fuses), else composed from two
    projections (llama.py:217-260, 326-340), or from three dense ones
    (:506-508). Fused: after K7 one K6 launch with the norm and residual
    inside (K6c or K6d at Q4_0, picked in ops/dispatch; K6a at Q8_0; where
    JAX runs K7's phase E the FFN is inside K7, `_fused_layer`); in
    `_layer_step` at Q4_0 rmsnorm, K6b and the
    residual, as JAX composes them, and at Q8_0 K6a (the same f32 sums).
    Under autograd `_layer_step` takes JAX's composition at both kinds:
    rmsnorm, the fused FFN (K6b, or K6a's no-norm form at Q8_0) through
    ops/ffn.FusedFFN, the residual; JAX has no backward for the normed form.
    Under tensor parallelism (cfg.d_ff the local one, which ffn_fuses reads
    as JAX's padding rules read the shard's local dict) a fused launch's
    output after K7 joins the stream as x + psum(x_new - x)
    (`_ffn_after_attn`, llama.py:224-228), and `_layer_step`'s FFN is JAX's
    composition at both kinds: _tp_copy at the normed rows, the down
    projection's output summed over the tp group."""
    if "w_gate" in layer:
        h = _tp_copy(ops.rmsnorm(x, layer["ffn_norm"], cfg.rms_norm_eps), tp)
        ff = refs.swiglu(ops.qmatmul(h, layer["w_gate"]), ops.qmatmul(h, layer["w_up"]))
        return x + _tp_reduce(ops.qmatmul(ff, layer["w_down"]), tp)
    rows = x.numel() // x.shape[-1]
    packed_ffn = all(isinstance(layer[n], PackedWeight) for n in ("w_gate_up", "w_down"))
    kind = layer["w_down"].kind if packed_ffn else None
    fuses = (packed_ffn and rows <= ffn.FFN_MAX_ROWS and config.kernel_on("fused_ffn")
             and layer["w_gate_up"].kind == kind
             and ffn.ffn_fuses(cfg.d_model, cfg.d_ff, kind, after_attn_block))
    if fuses and (after_attn_block or (kind == "q8_0" and tp is None
                                       and not ops.needs_grad(x))):
        x_new = ops.fused_ffn_norm(x, layer["ffn_norm"], layer["w_gate_up"], layer["w_down"],
                                   cfg.rms_norm_eps)
        return x_new if tp is None else x + _tp_reduce(x_new - x, tp)
    h = _tp_copy(ops.rmsnorm(x, layer["ffn_norm"], cfg.rms_norm_eps), tp)
    if fuses:
        return x + _tp_reduce(ops.fused_ffn(h, layer["w_gate_up"], layer["w_down"]), tp)
    gu = ops.qmatmul(h, layer["w_gate_up"])
    f = gu.shape[-1] // 2
    ff = refs.swiglu(gu[..., :f], gu[..., f:])
    return x + _tp_reduce(ops.qmatmul(ff, layer["w_down"]), tp)


def _fused_layer(cfg: LlamaConfig, x, layer: dict, ck, cv, li: int, pos_t, cos, sin,
                 tp: TPShard | None = None):
    """Batch-1 decode of one token through one layer: K7 then the FFN
    (llama.py:796-805, 366-395), or where JAX runs K7's phase E (`_phase_e`)
    one K7 launch with the FFN inside it; K7 writes the layer's K/V row at
    pos. Under tensor parallelism K7 runs on the rank's local heads without
    phase E (allow_ffn=tp_axis is None, llama.py:368) and its output joins
    the stream as x + psum(x2 - x) (llama.py:369-372), not x + psum(partial):
    the two differ in the bits."""
    ffn = ((layer["ffn_norm"], layer["w_gate_up"], layer["w_down"])
           if tp is None and _phase_e(cfg, layer) else None)
    x2, _, _ = ops.attn_block(x, layer["attn_norm"], layer["wqkv"], layer["wo"], ck, cv, li,
                              pos_t, cos, sin, cfg.n_heads, cfg.n_kv_heads, cfg.rms_norm_eps,
                              ffn)
    if ffn is not None:
        return x2
    if tp is not None:
        x2 = x + _tp_reduce(x2 - x, tp)
    return _ffn(cfg, x2, layer, after_attn_block=True, tp=tp)


class LlamaModel(torch.nn.Module):
    """Holds the config and the params dict; ``forward`` runs tokens through
    the stack against a cache from ``init_cache``. ``tp`` is None, or, once
    parallel/tp.shard_llama_params has replaced the params by this rank's
    shard, the rank's TPShard: its layers then run on local head counts
    (``layer_cfg``) and its cache holds the local KV heads."""

    def __init__(self, cfg: LlamaConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.params = params
        self.tp: TPShard | None = None

    @property
    def device(self) -> torch.device:
        return self.params["tok_embd"].device

    @property
    def layer_cfg(self) -> LlamaConfig:
        """The config the layers compute with: cfg, or under tensor
        parallelism the rank's local_config."""
        return self.cfg if self.tp is None else self.tp.cfg

    def quantize(self, kind: str = "q8_0") -> "LlamaModel":
        """Post-hoc weight quantization in place, as the JAX package's
        (llama.py:558-571): every dense matmul weight becomes a PackedWeight
        of `kind` on the model's device (io/llama_loader.quantize_llama_params);
        norms and embeddings stay f32. The port derives no weight view at
        load (the megacall views only on request), so there is none to
        re-derive. Returns self."""
        from zgml_tpu_torch.io.llama_loader import quantize_llama_params
        self.params = quantize_llama_params(self.params, kind)
        return self

    def enable_stacked_decode(self) -> bool:
        """Attach the K14 view (ops/stackkernel.py StackedLayers, a pointer
        table over the resident weights, no copy) as params["layers_stacked"]
        and return True, or return False and attach nothing where the JAX
        package's enable_stacked_decode does (llama.py:591-604). Decode takes
        it under ZGML_TPU_STACK_DECODE=1."""
        stacked = stack_llama_layers(self.params, self.cfg)
        if stacked is None:
            return False
        self.params["layers_stacked"] = stacked
        return True

    def enable_tape_decode(self) -> bool:
        """Attach the K15 view (ops/tapekernel.py Tape, over the same kind of
        pointer table) as params["layers_tape"] and return True, or return
        False and attach nothing where the JAX package's enable_tape_decode
        does (llama.py:606-620). Decode takes it under
        ZGML_TPU_TAPE_DECODE=1."""
        tape = build_tape(self.params, self.cfg)
        if tape is None:
            return False
        self.params["layers_tape"] = tape
        return True

    def init_cache(self, batch: int, dtype: str = "bf16") -> dict:
        """The stacked KV cache: "bf16", "f32" (the JAX package's
        init_cache(batch, jnp.float32), stacked as its bf16 one,
        llama.py:659-676: prefill through K3's f32-K/V forms, batch-1 decode
        through K7's f32-cache mode, K4's f32 form above), or "int8"
        (quant/kv_cache.py, as the JAX package's init_cache(batch, "int8"),
        llama.py:659-692); a tensor-parallel rank's holds its local KV heads
        (tp.py:375-378), a pipeline stage's its own layers' slabs (pp.py:
        the layers of its params)."""
        c = self.layer_cfg
        shape = (len(self.params["layers"]), batch, c.n_kv_heads, c.max_seq_len, c.head_dim)
        if dtype == "int8":
            return kv_cache.init_cache(*shape, device=self.device)
        dt = {"bf16": torch.bfloat16, "f32": torch.float32}.get(dtype)
        if dt is None:
            raise ValueError(f"cache dtype {dtype!r}: want 'bf16', 'f32' or 'int8'")
        return {"k": torch.zeros(shape, dtype=dt, device=self.device),
                "v": torch.zeros(shape, dtype=dt, device=self.device)}

    def _megacall(self):
        """(dispatch function, view) of the whole-stack megacall a batch-1
        decode token over the stacked bf16 or f32 cache takes, or None: the
        tape first, as llama.py:745-771."""
        tape, stack = self.params.get("layers_tape"), self.params.get("layers_stacked")
        if tape is not None and ops.megacall_enabled("tape_decode"):
            return ops.tape_decode, tape
        if stack is not None and ops.megacall_enabled("stack_decode"):
            return ops.stacked_decode, stack
        return None

    def body(self, tokens: torch.Tensor, cache: dict, pos, cache_row: int | None = None,
             write_pos: torch.Tensor | None = None) -> torch.Tensor:
        """tokens int [B, T] at positions pos.. -> hidden states f32 [B, T, D]
        before the final norm. Writes K/V of positions pos..pos+T-1 into
        `cache`; attention sees kv_len = pos + T (as llama.py:737).

        Continuous batching (zgml_tpu/models/llama.py:695-737), both on the
        `_layer_step` path alone, never K7, its phase E or the megacalls
        (llama.py:343-345, 747-750): `pos` an int32 tensor [B] on the device
        (decode only, T 1): RoPE per row, kv_len = pos + 1 per row, row b's
        K/V written at write_pos[b] (default pos[b]); `cache_row`: tokens of
        batch 1 into row cache_row of a cache of more rows, written at
        (li, cache_row, :, pos:pos+T) and attended through kv_row
        li * B' + cache_row. write_pos with an int pos takes that path too and
        writes at pos, as JAX does (it reads write_pos with per-row pos only).

        Under tensor parallelism (self.tp) every layer takes its local heads
        and the tp collectives; the megacalls are off (llama.py:748), and K7
        is chosen layer by layer, as over JAX's per-layer TP cache."""
        cfg, tp = self.layer_cfg, self.tp
        b, t = tokens.shape
        kv8 = "k_s" in cache
        shape = cache["k"].shape
        per_row = isinstance(pos, torch.Tensor) and pos.dim() == 1
        slots = per_row or cache_row is not None or write_pos is not None
        if cache_row is not None:
            if b != 1 or not 0 <= cache_row < shape[1]:
                raise ValueError(f"cache_row {cache_row}: want batch-1 tokens and a row of "
                                 f"the cache's {shape[1]}, got batch {b}")
        elif shape[1] != b:
            raise ValueError(f"cache batch {shape[1]}, tokens batch {b}")
        if per_row:
            if t != 1 or tuple(pos.shape) != (b,) or cache_row is not None:
                raise ValueError(f"per-row positions {tuple(pos.shape)} take single-token "
                                 f"decode of batch {b} into the whole cache, got {t} tokens")
        elif pos + t > shape[3]:
            raise ValueError(f"SequenceTooLong: pos {pos} + {t} tokens > {shape[3]}")
        ck, cv = ((cache["k"], cache["k_s"]), (cache["v"], cache["v_s"])) if kv8 else \
            (cache["k"], cache["v"])
        x = self.params["tok_embd"][tokens]
        decode = t == 1
        layers = self.params["layers"]
        if per_row:
            pos_v = pos.to(device=x.device, dtype=torch.int32)
            cos, sin = refs.rope_cos_sin(pos_v, cfg.head_dim, cfg.rope_base)
            cos, sin = cos[:, None, None, :], sin[:, None, None, :]   # [B, 1, 1, hd/2]
            kv_len = pos_v + t
            wp = pos_v if write_pos is None else write_pos.to(device=x.device,
                                                              dtype=torch.int32)
            for li, layer in enumerate(layers):
                x = _layer_step(cfg, x, layer, ck, cv, li, 0, kv_len, cos, sin, decode, wp=wp,
                                tp=tp)
            return x
        positions = torch.arange(pos, pos + t, device=x.device)
        cos, sin = refs.rope_cos_sin(positions, cfg.head_dim, cfg.rope_base)
        if slots:                  # a chunk into row cache_row, or write_pos with an int pos
            kv_len = pos + t
            decode = decode and cache_row is None   # a slot's chunk takes flash at any length
            if decode:
                kv_len = torch.full((b,), kv_len, dtype=torch.int32, device=x.device)
            for li, layer in enumerate(layers):
                x = _layer_step(cfg, x, layer, ck, cv, li, pos, kv_len, cos, sin, decode,
                                tp=tp, row0=cache_row or 0)
            return x
        mega = self._megacall() if decode and b == 1 and not kv8 and tp is None else None
        if mega is not None:
            run, view = mega
            pos_t = torch.full((1,), pos, dtype=torch.int32, device=x.device)
            return run(x, view, ck, cv, pos_t, cos, sin)[0]
        k7 = decode and config.attn_block() and config.kernel_on("attn_block")
        fused = [k7 and all(isinstance(ly.get(n), PackedWeight) for n in ("wqkv", "wo"))
                 and attn_block_compatible(cfg.head_dim, b, (ly["wqkv"].kind, ly["wo"].kind))
                 for ly in layers]
        if not kv8 and tp is None and not all(fused):
            fused = [False] * len(layers)        # the stacked bf16 cache: all layers or none
        pos_t = torch.full((1,), pos, dtype=torch.int32, device=x.device) if any(fused) else None
        kv_len = pos + t
        if decode and not all(fused):
            kv_len = torch.full((b,), kv_len, dtype=torch.int32, device=x.device)
        for li, layer in enumerate(layers):
            if fused[li]:
                x = _fused_layer(cfg, x, layer, ck, cv, li, pos_t, cos, sin, tp)
            else:
                x = _layer_step(cfg, x, layer, ck, cv, li, pos, kv_len, cos, sin, decode, tp=tp)
        return x

    def head(self, x: torch.Tensor, greedy: bool = False,
             tier_rows: int | None = None) -> torch.Tensor:
        """Final norm + lm_head: logits f32 [B, T, V], or with greedy the
        argmax ids int64 [B] of the last position (first index on ties; K5
        for batch 1). tier_rows: the row count of the call this head stands
        for (the prefill engine computes the last row of a chunk), which picks
        the projection's tier. Under tensor parallelism lm_head is the rank's
        vocab shard: its logits are gathered over the tp group, and greedy
        takes their argmax, never K5 (llama.py:517-543)."""
        tp = self.tp
        x = _tp_copy(ops.rmsnorm(x, self.params["out_norm"], self.cfg.rms_norm_eps), tp)
        lm_head = self.params.get("lm_head")
        if greedy and isinstance(lm_head, PackedWeight) and tp is None:
            tok = ops.qmatmul_greedy(x[:, -1], lm_head)
            if tok is not None:
                return tok
        if lm_head is None:       # tied embeddings: logits = x @ embd.T
            logits = x.to(torch.float32) @ self.params["tok_embd"].to(torch.float32).T
        else:
            logits = _tp_gather(ops.qmatmul(x, lm_head, tier_rows), tp)
        if greedy:
            return torch.argmax(logits[:, -1], dim=-1)
        return logits

    def train_body(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens int [B, T] -> hidden states f32 [B, T, D] before the final
        norm: the JAX forward from a fresh cache at pos 0, without the cache
        (module docstring); under tensor parallelism on the rank's local
        heads with the tp collectives, as the JAX train step's forward
        (tp.py:524-526)."""
        return self.train_layers(self.params["tok_embd"][tokens])

    def train_layers(self, x: torch.Tensor) -> torch.Tensor:
        """x f32 [B, T, D] (embedded, at positions 0..T-1) through the
        params' layers on the training path: train_body's loop, which a
        pipeline stage runs over its own layers (parallel/pp.py)."""
        cfg = self.layer_cfg
        t = x.shape[1]
        if t > cfg.max_seq_len:
            raise ValueError(f"SequenceTooLong: {t} tokens > max_seq_len {cfg.max_seq_len}")
        cos, sin = refs.rope_cos_sin(torch.arange(t, device=x.device), cfg.head_dim,
                                     cfg.rope_base)
        for layer in self.params["layers"]:
            x = _layer_step(cfg, x, layer, None, None, 0, 0, t, cos, sin, decode=False,
                            tp=self.tp)
        return x

    def forward(self, tokens: torch.Tensor, cache: dict | None = None, pos=0,
                greedy_head: bool = False, cache_row: int | None = None,
                write_pos: torch.Tensor | None = None) -> torch.Tensor:
        """tokens [B, T] -> logits [B, T, V] (or next ids [B] with
        greedy_head). With a cache, updates it in place (pos an int, or an
        int32 tensor [B] of per-row positions; cache_row and write_pos as in
        `body`); without one, the training function (train_body),
        differentiable."""
        if cache is None:
            body = self.train_body(tokens)
        else:
            body = self.body(tokens, cache, pos, cache_row, write_pos)
        return self.head(body, greedy=greedy_head)
