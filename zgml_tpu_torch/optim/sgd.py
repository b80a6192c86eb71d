"""SGD and SGD with momentum over trees of tensors; counterpart of
zgml_tpu/optim/sgd.py. Each returns new tensors (no update in place)."""
from __future__ import annotations

import torch

from zgml_tpu_torch.utils.tree import tree_map


@torch.no_grad()
def sgd_update(params, grads, lr):
    """Plain SGD: p - lr * g."""
    return tree_map(lambda p, g: (p - lr * g).to(p.dtype), params, grads)


@torch.no_grad()
def sgd_init(params):
    """Momentum state: zeros like params."""
    return tree_map(torch.zeros_like, params)


@torch.no_grad()
def sgd_momentum_update(params, grads, state, lr, momentum=0.9):
    """v = mu * v + g; p - lr * v. Returns (params, state)."""
    new_state = tree_map(lambda v, g: momentum * v + g, state, grads)
    new_params = tree_map(lambda p, v: (p - lr * v).to(p.dtype), params, new_state)
    return new_params, new_state
