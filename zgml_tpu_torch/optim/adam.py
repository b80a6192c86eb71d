"""Adam / AdamW over trees of tensors; counterpart of zgml_tpu/optim/adam.py.

The JAX formulas in their order and in f32 (the bias corrections b1t, b2t
are f32 scalars computed on the params' device; torch.optim.Adam orders the
arithmetic otherwise). Each call returns new tensors."""
from __future__ import annotations

import dataclasses

import torch

from zgml_tpu_torch.utils.tree import flatten, tree_map


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0   # > 0: AdamW (decoupled)


@torch.no_grad()
def adam_init(params):
    leaves, _ = flatten(params)
    dev = leaves[0].device if leaves else "cpu"
    return {"m": tree_map(torch.zeros_like, params), "v": tree_map(torch.zeros_like, params),
            "t": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adam_update(params, grads, state, cfg: AdamConfig = AdamConfig()):
    """Returns (new_params, new_state): bias-corrected, decoupled weight decay."""
    t = state["t"] + 1
    tf = t.to(torch.float32)
    b1t = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=t.device), tf)
    b2t = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=t.device), tf)
    m = tree_map(lambda m_, g: cfg.b1 * m_ + (1 - cfg.b1) * g, state["m"], grads)
    v = tree_map(lambda v_, g: cfg.b2 * v_ + (1 - cfg.b2) * g * g, state["v"], grads)

    def upd(p, m_, v_):
        mhat = m_ / b1t
        vhat = v_ / b2t
        step = cfg.lr * mhat / (torch.sqrt(vhat) + cfg.eps)
        if cfg.weight_decay:
            step = step + cfg.lr * cfg.weight_decay * p
        return (p - step).to(p.dtype)

    return tree_map(upd, params, m, v), {"m": m, "v": v, "t": t}
