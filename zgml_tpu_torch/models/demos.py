"""Demo models; counterpart of zgml_tpu/models/demos.py:16-130.

Linear and polynomial regression, the XOR MLP, the MLP and conv classifiers
and the autoencoder, each as init / forward / loss, trained with
nn/train.train_supervised or train_unsupervised. The initialisers draw the
JAX package's numpy values from the same seed and build on the card unless
device="cpu"; ``demo_params_from_jax`` carries a JAX params tree over. They
run no hand-written kernel, as the JAX demos run no Pallas one.
"""
from __future__ import annotations

import numpy as np
import torch

from zgml_tpu_torch.nn.layers import (batchnorm2d, batchnorm2d_init, conv2d, linear,
                                      linear_init, max_pool2d)
from zgml_tpu_torch.nn.losses import cross_entropy_idx, mean_sq_err
from zgml_tpu_torch.nn.train import train_supervised
from zgml_tpu_torch.ops.elementwise import unary
from zgml_tpu_torch.quant.packed import resolve_device
from zgml_tpu_torch.utils.tree import tree_map


def demo_params_from_jax(tree, device="cuda"):
    """A demo's params from the JAX package (a nested dict of arrays, each
    converted to numpy) -> the same tree of tensors on `device` (the card
    unless "cpu"), values and dtypes unchanged."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(dev), tree)


def _relu(x):
    return unary("relu", x)


# -- linear regression --------------------------------------------------------
def linear_regression_init(rng=None, device="cuda"):
    dev = resolve_device(device)
    return {"w": torch.zeros((1, 1), device=dev), "b": torch.zeros((1,), device=dev)}


def linear_regression_forward(p, x):
    return x @ p["w"] + p["b"]


def linear_regression_loss(p, x, y):
    return mean_sq_err(linear_regression_forward(p, x), y)


# -- polynomial regression ----------------------------------------------------
def poly_init(degree: int = 3, device="cuda"):
    return {"coef": torch.zeros((degree + 1,), device=resolve_device(device))}


def poly_forward(p, x):
    """x: [N, 1] -> sum_i coef[i] * x^i."""
    powers = torch.cat([x ** i for i in range(p["coef"].shape[0])], dim=1)
    return powers @ p["coef"][:, None]


def poly_loss(p, x, y):
    return mean_sq_err(poly_forward(p, x), y)


# -- XOR MLP ------------------------------------------------------------------
def xor_mlp_init(seed: int = 0, hidden: int = 8, device="cuda"):
    rng = np.random.default_rng(seed)
    return {"l1": linear_init(rng, 2, hidden, device=device),
            "l2": linear_init(rng, hidden, 1, device=device)}


def xor_mlp_forward(p, x):
    h = torch.tanh(linear(p["l1"], x))
    return torch.sigmoid(linear(p["l2"], h))


def xor_mlp_loss(p, x, y):
    return mean_sq_err(xor_mlp_forward(p, x), y)


def train_xor(epochs: int = 800, lr_cfg=None, device="cuda"):
    from zgml_tpu_torch.optim.adam import AdamConfig
    x = np.asarray([[0, 0], [0, 1], [1, 0], [1, 1]], np.float32)
    y = np.asarray([[0], [1], [1], [0]], np.float32)
    p = xor_mlp_init(device=device)
    return train_supervised(p, xor_mlp_loss, x, y, epochs=epochs, batch_size=4,
                            adam=lr_cfg or AdamConfig(lr=0.02))


# -- MLP classifier -----------------------------------------------------------
def mlp_classifier_init(d_in: int, hidden: int, n_classes: int, seed: int = 0, device="cuda"):
    rng = np.random.default_rng(seed)
    return {"l1": linear_init(rng, d_in, hidden, device=device),
            "l2": linear_init(rng, hidden, n_classes, device=device)}


def mlp_classifier_forward(p, x):
    return linear(p["l2"], _relu(linear(p["l1"], x)))


def mlp_classifier_loss(p, x, y):
    return cross_entropy_idx(mlp_classifier_forward(p, x), y)


# -- conv classifier ----------------------------------------------------------
def conv_classifier_init(n_classes: int = 10, seed: int = 0, batchnorm: bool = False,
                         device="cuda"):
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    p = {
        "c1": torch.from_numpy(rng.standard_normal((3, 3, 1, 8)).astype(np.float32) * 0.1).to(dev),
        "c2": torch.from_numpy(rng.standard_normal((3, 3, 8, 16)).astype(np.float32)
                               * 0.1).to(dev),
        "fc": linear_init(rng, 5 * 5 * 16, n_classes, device=dev),
    }
    if batchnorm:
        p["bn1"] = batchnorm2d_init(8, device=dev)
    return p


def conv_classifier_forward(p, x, train: bool = False):
    """x: [B, 28, 28] -> logits [B, n_classes]."""
    h = x[..., None]
    h = conv2d(h, p["c1"])                 # [B, 26, 26, 8]
    if "bn1" in p:
        h, _ = batchnorm2d(p["bn1"], h, train=False)
    h = _relu(h)
    h = max_pool2d(h)                      # [B, 13, 13, 8]
    h = _relu(conv2d(h, p["c2"]))          # [B, 11, 11, 16]
    h = max_pool2d(h)                      # [B, 5, 5, 16]
    return linear(p["fc"], h.reshape(h.shape[0], -1))


def conv_classifier_loss(p, x, y):
    return cross_entropy_idx(conv_classifier_forward(p, x), y)


# -- autoencoder --------------------------------------------------------------
def autoencoder_init(d_in: int = 784, d_hidden: int = 32, seed: int = 0, device="cuda"):
    rng = np.random.default_rng(seed)
    return {"enc": linear_init(rng, d_in, d_hidden, device=device),
            "dec": linear_init(rng, d_hidden, d_in, device=device)}


def autoencoder_forward(p, x):
    return torch.sigmoid(linear(p["dec"], torch.tanh(linear(p["enc"], x))))


def autoencoder_loss(p, x, y):
    return mean_sq_err(autoencoder_forward(p, x), y)
