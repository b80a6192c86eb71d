"""Training loops; counterpart of zgml_tpu/nn/train.py.

The same signatures and the same batches: each epoch permutes the rows with
numpy's default_rng(seed), as the JAX loop does, so both packages see
identical batches. The device is the params' device; each batch goes there
from numpy. The step is eager (no jit): value_and_grad, then adam_update.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from zgml_tpu_torch.optim.adam import AdamConfig, adam_init, adam_update
from zgml_tpu_torch.utils.tree import flatten


def value_and_grad(loss_fn: Callable, params, *args):
    """(loss, grads) of loss_fn(params, *args) with respect to every tensor
    leaf of params (the counterpart of jax.value_and_grad); grads has the
    tree of params, zeros where a leaf does not reach the loss."""
    leaves, rebuild = flatten(params)
    leaves = [t.detach().requires_grad_() for t in leaves]
    loss = loss_fn(rebuild(leaves), *args)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), rebuild([torch.zeros_like(t) if g is None else g
                                   for t, g in zip(leaves, grads)])


def train_supervised(params, loss_fn: Callable, data_x, data_y,
                     epochs: int = 10, batch_size: int = 32,
                     adam: AdamConfig = AdamConfig(), seed: int = 0,
                     log_every: int = 0):
    """loss_fn(params, x, y) -> scalar tensor. Returns (params, losses), the
    mean loss of each epoch."""
    state = adam_init(params)
    dev = flatten(params)[0][0].device
    rng = np.random.default_rng(seed)
    n = len(data_x)
    losses = []
    for epoch in range(epochs):
        perm = rng.permutation(n)
        total, batches = 0.0, 0
        for i in range(0, n - batch_size + 1, batch_size):
            idx = perm[i:i + batch_size]
            x = torch.as_tensor(np.asarray(data_x[idx]), device=dev)
            y = torch.as_tensor(np.asarray(data_y[idx]), device=dev)
            loss, grads = value_and_grad(loss_fn, params, x, y)
            params, state = adam_update(params, grads, state, adam)
            total += float(loss)
            batches += 1
        losses.append(total / max(1, batches))
        if log_every and (epoch + 1) % log_every == 0:
            print(f"epoch {epoch+1}: loss {losses[-1]:.5f}")
    return params, losses


def train_unsupervised(params, loss_fn: Callable, data_x, **kw):
    """Autoencoder-style: loss_fn(params, x, x)."""
    return train_supervised(params, loss_fn, data_x, data_x, **kw)
