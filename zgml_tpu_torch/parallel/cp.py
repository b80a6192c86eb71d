"""Context parallelism: one prefill of a long prompt sharded over a 'cp' group.

Counterpart of zgml_tpu/parallel/cp.py (27-113). Each rank of the group
embeds and projects its T/cp-token chunk (positions idx * t_loc + arange)
and attends over the whole prefix through ring attention
(parallel/ring.py), so a rank holds O(T/cp) activations and the prefill's
T^2 term splits cp ways. The layers are JAX's cp body, not the engine's
`_layer_step`: rmsnorm, the projections through dispatch.qmatmul (K2, or K1
at <= 32 rows), q / k / v in f32 into the ring, the composed FFN
(swiglu of the gate|up projection, then w_down; never the fused FFN).

Each layer's K/V (after RoPE, f32) are gathered over the group, so every
rank ends with the whole prompt's cache; LlamaEngine.prefill_cp writes it
and decode continues on the normal path. Every rank holds the whole model
(JAX's replicated params, P()).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from zgml_tpu_torch.models.llama import LlamaModel, _qkv
from zgml_tpu_torch.ops import dispatch as ops
from zgml_tpu_torch.ops import refs
from zgml_tpu_torch.parallel.mesh import all_gather
from zgml_tpu_torch.parallel.ring import ring_attention_local


def cp_prefill(model: LlamaModel, group, tokens: torch.Tensor):
    """tokens [B, t_loc]: this rank's chunk of the prompt (rank idx of the
    group holds positions idx * t_loc ..). Returns (x f32 [B, t_loc, D], the
    hidden states before the final norm; [(k, v)] per layer, f32 [B, Hkv,
    cp * t_loc, hd], the whole prompt's K/V after RoPE, gathered)."""
    if model.tp is not None:
        raise ValueError("cp_prefill runs an unsharded model on every rank of the cp group")
    cfg = model.cfg
    idx = dist.get_rank(group)
    b, t_loc = tokens.shape
    params = model.params
    x = params["tok_embd"][tokens.to(model.device)]
    positions = idx * t_loc + torch.arange(t_loc, device=x.device)
    cos, sin = refs.rope_cos_sin(positions, cfg.head_dim, cfg.rope_base)
    kv = []
    for layer in params["layers"]:
        h = ops.rmsnorm(x, layer["attn_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(cfg, h, layer)
        q, k = ops.rope_apply(q, cos, sin), ops.rope_apply(k, cos, sin)
        att = ring_attention_local(q.float(), k.float(), v.float(), group)
        att = att.transpose(1, 2).reshape(b, t_loc, cfg.n_heads * cfg.head_dim)
        x = x + ops.qmatmul(att, layer["wo"])
        h = ops.rmsnorm(x, layer["ffn_norm"], cfg.rms_norm_eps)
        if "w_gate_up" in layer:
            gu = ops.qmatmul(h, layer["w_gate_up"])
            f = gu.shape[-1] // 2
            gate, up = gu[..., :f], gu[..., f:]
        else:
            gate, up = ops.qmatmul(h, layer["w_gate"]), ops.qmatmul(h, layer["w_up"])
        x = x + ops.qmatmul(refs.swiglu(gate, up), layer["w_down"])
        kv.append(tuple(all_gather(u.float().contiguous(), group, dim=2) for u in (k, v)))
    return x, kv
