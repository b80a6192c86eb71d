"""NN building blocks; counterpart of zgml_tpu/nn/layers.py:12-97.

Functional: params are dicts of tensors, layers are plain functions. The
initialisers draw from a numpy Generator exactly as the JAX package's do, so
one seed gives both packages byte-identical params; they build on the card
unless device="cpu". Activations keep the JAX layouts: conv2d takes NHWC
activations and HWIO weights and max_pool2d NHWC, permuted around torch's
NCHW calls.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from zgml_tpu_torch.ops import refs
from zgml_tpu_torch.ops.elementwise import unary
from zgml_tpu_torch.quant.packed import resolve_device


def kaiming_init(rng: np.random.Generator, fan_in: int, shape, device="cuda") -> torch.Tensor:
    """Kaiming-uniform: U(-sqrt(6 / fan_in), sqrt(6 / fan_in)), f32."""
    bound = float(np.sqrt(6.0 / fan_in))
    return torch.from_numpy(rng.uniform(-bound, bound, shape).astype(np.float32)).to(
        resolve_device(device))


def linear_init(rng: np.random.Generator, d_in: int, d_out: int, bias: bool = True,
                device="cuda") -> dict:
    p = {"w": kaiming_init(rng, d_in, (d_in, d_out), device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=torch.float32, device=resolve_device(device))
    return p


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = torch.matmul(x.to(torch.float32), p["w"].to(torch.float32))
    if "b" in p:
        y = y + p["b"]
    return y.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return unary("silu", x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu's default, the tanh form (torch's F.gelu defaults to erf)."""
    return unary("gelu", x)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None = None,
            train: bool = True) -> torch.Tensor:
    """Inverted dropout with an eager mask; `generator` (on x's device) takes
    the place of the JAX key, and draws other bits than it."""
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def causal_mask(t: int, device=None) -> torch.Tensor:
    """[t, t] boolean lower-triangular mask."""
    return refs.causal_mask(t, t, device=device)


def argmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.argmax(x, dim=axis)


def batchnorm2d_init(channels: int, device="cuda") -> dict:
    dev = resolve_device(device)
    return {"gamma": torch.ones(channels, device=dev), "beta": torch.zeros(channels, device=dev),
            "mean": torch.zeros(channels, device=dev), "var": torch.ones(channels, device=dev)}


def batchnorm2d(p: dict, x: torch.Tensor, train: bool = True, eps: float = 1e-5,
                momentum: float = 0.1):
    """x [B, H, W, C]. Returns (y, updated params); in train mode the batch
    statistics (biased variance, as jnp.var) and the running ones updated."""
    if train:
        mu = torch.mean(x, dim=(0, 1, 2))
        var = torch.var(x, dim=(0, 1, 2), unbiased=False)
        new_p = dict(p)
        new_p["mean"] = (1 - momentum) * p["mean"] + momentum * mu
        new_p["var"] = (1 - momentum) * p["var"] + momentum * var
    else:
        mu, var = p["mean"], p["var"]
        new_p = p
    y = (x - mu) * torch.rsqrt(var + eps) * p["gamma"] + p["beta"]
    return y, new_p


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: the output has ceil(size /
    stride) positions, the total padding split low = total // 2."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _no_tf32(x: torch.Tensor):
    """cuDNN runs f32 convolutions in TF32 by default; the JAX reference's
    conv is f32, so TF32 is off inside the call (and nothing else changes)."""
    if not x.is_cuda:
        return contextlib.nullcontext()
    b = torch.backends.cudnn
    return b.flags(enabled=b.enabled, benchmark=b.benchmark, deterministic=b.deterministic,
                   allow_tf32=False)


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
           padding: str = "VALID") -> torch.Tensor:
    """x [B, H, W, Cin], w [kh, kw, Cin, Cout] -> [B, OH, OW, Cout], as
    jax.lax.conv_general_dilated with ("NHWC", "HWIO", "NHWC"). "SAME" pads
    explicitly (torch's padding="same" refuses stride > 1)."""
    xn = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        kh, kw = w.shape[0], w.shape[1]
        top, bottom = _same_pads(x.shape[1], kh, stride)
        left, right = _same_pads(x.shape[2], kw, stride)
        xn = F.pad(xn, (left, right, top, bottom))
    elif padding != "VALID":
        raise ValueError(f"conv2d padding {padding!r}: want 'VALID' or 'SAME'")
    with _no_tf32(x):
        y = F.conv2d(xn, w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)


def max_pool2d(x: torch.Tensor, window: int = 2, stride: int | None = None) -> torch.Tensor:
    """x [B, H, W, C]: the max over each window x window patch at `stride`
    (default window), VALID (no padding), as the JAX -inf-initialised
    reduce_window."""
    stride = stride or window
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride)
    return y.permute(0, 2, 3, 1)
