"""Lower a LazyTensor node to torch: the rules of zgml_tpu/graph/lower.py:20-119.

Each rule computes what the JAX rule computes, in torch, on the tensors of its
sources; the graph runs them eagerly (graph/graph.py). Where the two
frameworks' defaults differ, the rule follows JAX:

  GELU          the tanh form (jax.nn.gelu's default approximate=True)
  MAX2, RELU    NaN in either operand gives NaN (jnp.maximum)
  MATMUL        f32 torch.matmul, TF32 off (preferred_element_type=f32)
  SCATTER_ADD   duplicate indices accumulate (.at[].add)
  SLICE_ASSIGN  a copy with src written at static offsets (dynamic_update_slice)
  ATTENTION     refs.attention_ref with refs.causal_mask(tq, tk)
  RMSNORM, LAYERNORM  the plain refs, as lower.py:91-94 (the graph tier does
                not reach K12)
  CONV2D, MAXPOOL2D   nn/layers.py, NHWC / HWIO

The elementwise ops are ops/elementwise.py's ``unary`` and ``binary``, which
the fused chain (K13) and its plain version also compute.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from zgml_tpu_torch.graph.op import Op
from zgml_tpu_torch.graph.tensor import LazyTensor
from zgml_tpu_torch.nn import layers
from zgml_tpu_torch.ops import refs
from zgml_tpu_torch.ops.elementwise import binary, unary

UNARY_OPS = (Op.NEG, Op.RECIP, Op.SQR, Op.SQRT, Op.EXP, Op.LOG, Op.ABS, Op.TANH, Op.SIGMOID,
             Op.RELU, Op.SILU, Op.GELU, Op.SCALE, Op.ADD_SCALAR)
BINARY_OPS = (Op.ADD, Op.SUB, Op.MUL, Op.DIV, Op.MAX2)


def as_tensor(value, device) -> torch.Tensor:
    """A feed or constant as a torch tensor on `device`, with JAX's default
    dtypes: numpy float64 / int64 become float32 / int32 (jnp.asarray without
    x64)."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    arr = np.asarray(value)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    elif arr.dtype == np.int64:
        arr = arr.astype(np.int32)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("Op.MATMUL is an f32 product (preferred_element_type=f32): set "
                           "torch.backends.cuda.matmul.allow_tf32 = False, TF32 computes "
                           "another function")
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def _reduce(op: Op, x: torch.Tensor, axes: tuple, keepdims: bool) -> torch.Tensor:
    if not axes:                  # jnp reduces over no axis: the input itself
        return x
    if op == Op.SUM:
        return torch.sum(x, dim=axes, keepdim=keepdims)
    if op == Op.MAX:
        return torch.amax(x, dim=axes, keepdim=keepdims)
    return torch.mean(x, dim=axes, keepdim=keepdims)


def lower_node(node: LazyTensor, vals: dict[int, Any], device) -> torch.Tensor:
    """Evaluate one node given its sources' values (on `device`)."""
    op = node.op
    srcs = [vals[s.id] for s in node.srcs]
    if op == Op.VAR:
        raise KeyError(f"unbound var {node.name!r}")
    if op == Op.CONST:
        return as_tensor(node.payload, device)
    if op in UNARY_OPS:
        return unary(op.value, srcs[0], node.payload if node.payload is not None else 0.0)
    if op in BINARY_OPS:
        return binary(op.value, srcs[0], srcs[1])
    if op == Op.RESHAPE:
        return torch.reshape(srcs[0], node.shape)
    if op == Op.TRANSPOSE:
        return torch.swapaxes(srcs[0], -1, -2)
    if op == Op.PERMUTE:
        return srcs[0].permute(*node.payload)
    if op == Op.BROADCAST_TO:
        return torch.broadcast_to(srcs[0], node.shape)
    if op == Op.SLICE:
        starts, sizes = node.payload
        return srcs[0][tuple(slice(st, st + sz) for st, sz in zip(starts, sizes))]
    if op in (Op.SUM, Op.MAX, Op.MEAN):
        axes, keepdims = node.payload
        return _reduce(op, srcs[0], axes, keepdims)
    if op == Op.GATHER_ROWS:
        return srcs[0][srcs[1].to(torch.int64)]
    if op == Op.PICK_ROWS:
        idx = srcs[1].to(torch.int64)
        return torch.gather(srcs[0], -1, idx[..., None])[..., 0]
    if op == Op.SCATTER_ADD_ROWS:
        return srcs[0].index_add(0, srcs[2].to(torch.int64), srcs[1].to(srcs[0].dtype))
    if op == Op.SLICE_ASSIGN:
        out = srcs[0].clone()
        out[tuple(slice(st, st + sz) for st, sz in zip(node.payload, srcs[1].shape))] = \
            srcs[1].to(out.dtype)
        return out
    if op == Op.ROPE:
        return refs.rope_apply(srcs[0], srcs[1], srcs[2])
    if op == Op.SOFTMAX:
        return torch.softmax(srcs[0], dim=node.payload)
    if op == Op.LOG_SOFTMAX:
        return torch.log_softmax(srcs[0], dim=node.payload)
    if op == Op.RMSNORM:
        return refs.rmsnorm(srcs[0], srcs[1], node.payload)
    if op == Op.LAYERNORM:
        return refs.layernorm_ref(srcs[0], srcs[1], srcs[2], node.payload)
    if op == Op.CONV2D:
        stride, padding = node.payload
        return layers.conv2d(srcs[0], srcs[1], stride, padding)
    if op == Op.MAXPOOL2D:
        window, stride = node.payload
        return layers.max_pool2d(srcs[0], window, stride)
    if op == Op.MATMUL:
        trans_a, trans_b = node.payload
        a = torch.swapaxes(srcs[0], -1, -2) if trans_a else srcs[0]
        b = torch.swapaxes(srcs[1], -1, -2) if trans_b else srcs[1]
        return _matmul(a, b)
    if op == Op.ATTENTION:
        causal, scale = node.payload
        q, k, v = srcs
        mask = refs.causal_mask(q.shape[-2], k.shape[-2], device=q.device) if causal else None
        return refs.attention_ref(q, k, v, mask, scale)
    if op == Op.CROSS_ENTROPY:
        logits, idx = srcs
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        picked = torch.gather(logp, -1, idx.to(torch.int64)[..., None])[..., 0]
        return -torch.mean(picked)
    raise NotImplementedError(op)
