"""K14: the all-layers decode megacall and its plain version.

Counterpart of zgml_tpu/ops/stackkernel.py: `stack_llama_layers` (the view
that LlamaModel.enable_stacked_decode() attaches) and `_stack_kernel` through
`stacked_decode_step` (pallas_call at line 422), which the JAX package runs
for a batch-1 decode token over the stacked bf16 cache where the view is
attached and ZGML_TPU_STACK_DECODE is on (models/llama.py:764-771). It
computes, for every layer in order, the default K7's function (rmsnorm, the
QKV projection with the f32 A phase, RoPE, attention over the cache rows
below pos plus the current token's own f32 K/V, wo, residual) and then K6d's
(rmsnorm, gate|up, SwiGLU, down, residual), Q4_0 weights, one launch per
token. It takes the f32 A phase at any width: ZGML_TPU_ATTN_I8A and
ZGML_TPU_FFN_I8A do not reach it.

The JAX view stacks copies of every layer's weights ([L, ...] arrays, the
head-major wo3 and N-packed FFN layouts). The port's view, StackedLayers,
copies no weight: it holds a device table of per-layer pointers into the
model's one resident copy (g1, g2 and the qs / d planes of wqkv, wo,
w_gate_up, w_down) and references to the tensors behind them, so it must be
rebuilt if the params are replaced. `stack_llama_layers` attaches it exactly
where the JAX package's returns a view (see q4_views).

Layouts: x f32 [1, 1, d]; the stacked cache ck / cv [L, 1, Hkv, S, hd],
bf16 or f32 (models/llama.py init_cache), which both versions write IN
PLACE at row pos of every layer with the current K/V cast to the cache's
dtype (the JAX package writes them after the call, stackkernel.py:529-530;
phase B reads rows below pos only, in f32, so the cache ends the same);
cos / sin the [1, hd/2] tables of pos; on the card pos is an int32
[1] tensor on the device. Returns (x_out [1, 1, d], k_cur [L, Hkv, hd],
v_cur [L, Hkv, hd]), f32, k_cur rotated, as the JAX kernel's outputs.
Callers go through ``ops.dispatch.stacked_decode``.
"""
from __future__ import annotations

import torch

from zgml_tpu_torch import config
from zgml_tpu_torch.ops import build, coop, decode_plan, ffn, refs
from zgml_tpu_torch.ops.layerkernel import HEAD_DIMS, attn_block_cuda, attn_block_ref
from zgml_tpu_torch.quant.blocks import QK
from zgml_tpu_torch.quant.packed import PackedWeight
from zgml_tpu_torch.runtime.profile import global_profile

PROJECTIONS = ("wqkv", "wo", "w_gate_up", "w_down")
# the device table's columns, in csrc/stack_decode.cu TableSlot order:
# (layer key, plane of its PackedWeight or None for a norm)
TABLE = (("attn_norm", None), ("ffn_norm", None), ("wqkv", "qs"), ("wqkv", "d"), ("wo", "qs"),
         ("wo", "d"), ("w_gate_up", "qs"), ("w_gate_up", "d"), ("w_down", "qs"), ("w_down", "d"))


class StackedLayers:
    """The port's view of a layer stack for the whole-stack decode kernels
    (K14, and K15 through ops/tapekernel.Tape): the layer dicts, the heads
    and eps, and `table`, int64 [L, len(TABLE)] on the layers' device, the
    data pointers of each layer's norms and weight planes. Copies no weight."""

    def __init__(self, layers: list[dict], n_heads: int, n_kv_heads: int, eps: float):
        self.layers = list(layers)
        self.n_heads, self.n_kv_heads, self.eps = n_heads, n_kv_heads, eps
        # references keep every pointed-to tensor alive as long as the table
        self.tensors = [[ly[key] if plane is None else getattr(ly[key], plane)
                         for key, plane in TABLE] for ly in self.layers]
        dev = self.tensors[0][0].device
        if dev.type == "cuda" and not all(t.is_contiguous() and t.data_ptr() % 16 == 0
                                          for row in self.tensors for t in row):
            raise ValueError("StackedLayers: the norms and the weights' planes must be "
                             "contiguous and 16-byte aligned (bulk copies)")
        self.table = torch.tensor([[t.data_ptr() for t in row] for row in self.tensors],
                                  dtype=torch.int64, device=dev)

    @property
    def head_dim(self) -> int:
        return self.layers[0]["wo"].k // self.n_heads


def q4_views(cfg, layers) -> bool:
    """Whether the JAX loader attaches both views the megacalls read, the
    head-major wo3 and the N-packed FFN ffn_q4n (attach_head_major,
    zgml_tpu/quant/headmajor.py:266-293, run at load under
    ZGML_TPU_ATTN_BLOCK, llama_loader.py:172-178), and both are Q4_0: every
    projection Q4_0, head_dim a multiple of 32 and >= 32, wo's K exactly the
    query heads, and the FFN fused after the layer kernel (the padded d a
    multiple of 512, ops/ffn.ffn_fuses). The port reads config.attn_block()
    when a view is asked for, where the JAX package read it at load."""
    hd = cfg.head_dim
    if not config.attn_block() or hd % QK or hd < QK:
        return False
    if not all(isinstance(ly.get(n), PackedWeight) and ly[n].kind == "q4_0"
               for ly in layers for n in PROJECTIONS):
        return False
    return (all(ly["wo"].k == cfg.n_heads * hd for ly in layers)
            and ffn.ffn_fuses(cfg.d_model, cfg.d_ff, "q4_0", after_attn_block=True))


def stack_llama_layers(params: dict, cfg) -> StackedLayers | None:
    """The K14 view of params' layer list, or None exactly where the JAX
    `stack_llama_layers` (stackkernel.py:440-474) returns None: no layer
    list, or not q4_views. Its other rules (padded d a multiple of 512, the
    same padded widths in every layer, wo3 no wider than the padded d) hold
    for every Q4_0 model the JAX loader pads (config.padded_k)."""
    layers = params.get("layers")
    if not isinstance(layers, (list, tuple)) or not layers or not q4_views(cfg, layers):
        return None
    return StackedLayers(layers, cfg.n_heads, cfg.n_kv_heads, cfg.rms_norm_eps)


def stacked_decode_ref(x: torch.Tensor, stack: StackedLayers, ck: torch.Tensor,
                       cv: torch.Tensor, pos, cos: torch.Tensor, sin: torch.Tensor,
                       mm=refs.qmatmul_ref):
    """K14's plain version: per layer layerkernel.attn_block_ref (f32 A phase,
    the bf16 or f32 cache, row pos written in place) then
    ffn.fused_ffn_norm_ref, each projection through `mm` (K15's plain version
    passes its bf16 one)."""
    hkv = stack.n_kv_heads
    ks, vs = [], []
    for li, ly in enumerate(stack.layers):
        x, k, v = attn_block_ref(x, ly["attn_norm"], ly["wqkv"], ly["wo"], ck, cv, li, pos, cos,
                                 sin, stack.n_heads, hkv, stack.eps, mm=mm)
        x = ffn.fused_ffn_norm_ref(x, ly["ffn_norm"], ly["w_gate_up"], ly["w_down"], stack.eps,
                                   mm=mm)
        ks.append(k.reshape(hkv, -1))
        vs.append(v.reshape(hkv, -1))
    return x, torch.stack(ks), torch.stack(vs)


def layer_chain(x: torch.Tensor, stack: StackedLayers, ck: torch.Tensor, cv: torch.Tensor,
                pos: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """The per-layer chain K14 replaces, on the card: K7 (f32 A phase, in the
    cache's form: bf16, or its f32-cache mode) then K6d at one row, for
    every layer. Same contract as stacked_decode_cuda; K14 and
    tape_decode_f32 give its bits over either cache."""
    hkv = stack.n_kv_heads
    ks, vs = [], []
    for li, ly in enumerate(stack.layers):
        x, k, v = attn_block_cuda(x, ly["attn_norm"], ly["wqkv"], ly["wo"], ck, cv, li, pos,
                                  cos, sin, stack.n_heads, hkv, stack.eps, False)
        x = ffn.fused_ffn_norm_cuda(x, ly["ffn_norm"], ly["w_gate_up"], ly["w_down"],
                                    stack.eps, False)
        ks.append(k.reshape(hkv, -1))
        vs.append(v.reshape(hkv, -1))
    return x, torch.stack(ks), torch.stack(vs)


def stacked_decode_f64(x: torch.Tensor, stack: StackedLayers, ck: torch.Tensor,
                       cv: torch.Tensor, pos: int, cos: torch.Tensor, sin: torch.Tensor,
                       weight=PackedWeight.dequant) -> torch.Tensor:
    """The megacalls' function in float64 (ck / cv as before the call: rows
    below pos are read, none is written): every projection on weight(W)
    (the exact dequantized weight, or tapekernel.bf16_weight for K15's);
    norms, RoPE, attention and residuals in float64. K15's operand rows stay
    unrounded: rounded from their float64 values they flip other elements
    than an f32 evaluation rounds, and one flip outweighs every f32 sum.
    Returns (x_out, k_cur, v_cur) flattened into one vector, the yardstick
    of the rms checks."""
    hq, hkv = stack.n_heads, stack.n_kv_heads
    hd = cos.numel() * 2
    c, s = cos.double().reshape(-1), sin.double().reshape(-1)

    def mm(a, w):
        return a @ weight(w).double().T

    def norm(a, gam):
        return a * torch.rsqrt((a * a).mean() + stack.eps) * gam.double()

    def rope(t):
        t1, t2 = t[..., :hd // 2], t[..., hd // 2:]
        return torch.cat([t1 * c - t2 * s, t2 * c + t1 * s], dim=-1)
    nq, nkv, f = hq * hd, hkv * hd, stack.layers[0]["w_down"].k
    x = x.double().reshape(-1)
    ks, vs = [], []
    for li, ly in enumerate(stack.layers):
        qkv = mm(norm(x, ly["attn_norm"]), ly["wqkv"])
        q = rope(qkv[:nq].reshape(hkv, hq // hkv, hd))
        k, v = rope(qkv[nq:nq + nkv].reshape(hkv, hd)), qkv[nq + nkv:].reshape(hkv, hd)
        keys = torch.cat([ck[li, 0, :, :pos].double(), k[:, None]], dim=1)
        vals = torch.cat([cv[li, 0, :, :pos].double(), v[:, None]], dim=1)
        p = torch.softmax(torch.einsum("grd,gsd->grs", q, keys) / hd ** 0.5, dim=-1)
        x2 = x + mm(torch.einsum("grs,gsd->grd", p, vals).reshape(-1), ly["wo"])
        gu = mm(norm(x2, ly["ffn_norm"]), ly["w_gate_up"])
        x = x2 + mm(gu[:f] * torch.sigmoid(gu[:f]) * gu[f:], ly["w_down"])
        ks.append(k)
        vs.append(v)
    return torch.cat([x, torch.stack(ks).reshape(-1), torch.stack(vs).reshape(-1)])


def kv_form(ck: torch.Tensor) -> int:
    """The megacalls' cache form (decode_plan.KV_BF16 / KV_F32) of a cache
    slab; K7's codes (layerkernel.cache_form), the int8 cache excluded."""
    return decode_plan.KV_F32 if ck.dtype == torch.float32 else decode_plan.KV_BF16


def counter(kv: int) -> str:
    """K14's placement counter: stack_decode, or stack_decode_f32kv over the
    f32 cache."""
    return "stack_decode" + ("_f32kv" if kv == decode_plan.KV_F32 else "")


def launch(x: torch.Tensor, stack: StackedLayers, ck: torch.Tensor, cv: torch.Tensor,
           pos: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, bf16_ops: bool):
    """Launch csrc/stack_decode.cu (K14 with f32 operands, K15 with bf16
    ones) over the bf16 or the f32 cache on the plan of
    decode_plan.stack_plan (cached per shape and card; the f32 cache's plan
    is the bf16 cache's); the contract of stacked_decode_ref, pos an int32
    [1] CUDA tensor. A head dim without an instantiation, or a shape the
    plan cannot fit, raises NotImplementedError. Counts nothing: the
    wrappers of K14 and K15 do."""
    def require(cond, msg):
        if not cond:
            raise ValueError(f"stack_decode: {msg}")
    dev = x.device
    hq, hkv, hd = stack.n_heads, stack.n_kv_heads, stack.head_dim
    n_layers, d, f = len(stack.layers), x.shape[-1], stack.layers[0]["w_down"].k
    head_dims = (64, 128, 256) if bf16_ops else HEAD_DIMS
    if hd not in head_dims:
        raise NotImplementedError(
            f"head_dim {hd}: the whole-stack decode kernel is compiled for head dims "
            f"{head_dims} ({'bf16' if bf16_ops else 'f32'} operands)")
    require(x.is_cuda and all(t.device == dev for t in (ck, cv, cos, sin, pos, stack.table)),
            f"x on {x.device}: every tensor and the layers' table must be on one CUDA device")
    require(isinstance(pos, torch.Tensor) and pos.dtype == torch.int32 and pos.numel() == 1,
            "pos must be an int32 [1] tensor on the card")
    require(x.dtype == torch.float32 and x.numel() == d == hq * hd == stack.layers[0]["wqkv"].k,
            f"x must be one float32 row of {hq * hd}, got {x.dtype} {tuple(x.shape)}")
    require(ck.dtype in (torch.bfloat16, torch.float32) and cv.dtype == ck.dtype
            and ck.shape == cv.shape and ck.dim() == 5
            and tuple(ck.shape[:3]) == (n_layers, 1, hkv) and ck.shape[4] == hd,
            f"cache {tuple(ck.shape)} {ck.dtype} / {cv.dtype}: want both bf16 or both f32 "
            f"[{n_layers}, 1, {hkv}, S, {hd}]")
    require(cos.dtype == torch.float32 and sin.dtype == torch.float32
            and cos.numel() == hd // 2 and sin.numel() == hd // 2,
            f"cos/sin must be float32 [{hd // 2}]")
    require(all(t.is_contiguous() for t in (x, ck, cv, cos, sin)),
            "x, the cache and cos/sin must be contiguous")
    s = ck.shape[3]
    _, plan, bounds = decode_plan.launch_args(dev, decode_plan.stack_plan, n_layers, d, hq, hkv,
                                              hd, f, s)
    lib = build.library()
    n_split = lib.zgml_decode_split_count(s)
    if x.data_ptr() % 16:
        x = x.clone()                 # the kernel bulk-copies x
    x_out = torch.empty_like(x)
    kv_cur = torch.empty((n_layers, 2, hkv, hd), dtype=torch.float32, device=dev)
    sizes = [d, d, f, hq * hd, hq * hd, hq * n_split * (hd + 2)]   # x2, xres 16-byte aligned
    x2_s, xres_s, act_s, q_s, att_s, part_s = torch.empty(
        sum(sizes), dtype=torch.float32, device=dev).split(sizes)
    status = lib.zgml_stack_decode(
        int(bf16_ops), kv_form(ck), stack.table.data_ptr(), x.data_ptr(), cos.data_ptr(), sin.data_ptr(),
        ck.data_ptr(), cv.data_ptr(), pos.data_ptr(), x_out.data_ptr(), kv_cur.data_ptr(),
        q_s.data_ptr(), att_s.data_ptr(), part_s.data_ptr(), x2_s.data_ptr(), xres_s.data_ptr(),
        act_s.data_ptr(), coop.barrier_words(dev).data_ptr(),
        coop.counter_words(dev, hkv).data_ptr(), n_layers, d, hq, hkv, hd, s, f,
        float(stack.eps), 1.0 / hd ** 0.5, plan, bounds.data_ptr(), bounds.device.index,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, "stack_decode")
    return x_out, kv_cur[:, 0], kv_cur[:, 1]


def stacked_decode_cuda(x: torch.Tensor, stack: StackedLayers, ck: torch.Tensor,
                        cv: torch.Tensor, pos: torch.Tensor, cos: torch.Tensor,
                        sin: torch.Tensor):
    """Launch K14 (csrc/stack_decode.cu, f32 operands); counted under
    counter(kv_form(ck))."""
    out = launch(x, stack, ck, cv, pos, cos, sin, bf16_ops=False)
    global_profile.count_op(counter(kv_form(ck)), "cuda")
    return out
