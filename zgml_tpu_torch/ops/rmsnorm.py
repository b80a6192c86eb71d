"""K12: the row rmsnorm kernel, its plain version, and its autograd Function.

Counterpart of zgml_tpu/ops/rmsnorm.py (`_rmsnorm_kernel` / `_rmsnorm2d` /
`rmsnorm_pallas`): out = x * rsqrt(mean(x^2) + eps) * gamma over the last
dim, f32 math, out in x's dtype. ``rmsnorm_cuda`` launches csrc/rmsnorm.cu
(x f32 or bf16, gamma f32); ``rmsnorm_ref`` is refs.rmsnorm. ``RMSNorm``
joins them for autograd as the JAX custom VJP does: the forward is K12 (or
the plain version), the backward recomputes refs.rmsnorm under autograd
(rmsnorm.py:59-65).

Callers go through ``ops.dispatch.rmsnorm``, which takes K12 only where
ZGML_TPU_KERNELS_FORCE names "rmsnorm" (the JAX package's default there is
plain XLA, dispatch.py:144-155).
"""
from __future__ import annotations

import torch

from zgml_tpu_torch.ops import build, refs
from zgml_tpu_torch.runtime.profile import global_profile

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

rmsnorm_ref = refs.rmsnorm


def rmsnorm_cuda(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Launch K12: x f32 or bf16 [..., d], gamma f32 [d] -> out [..., d] in
    x's dtype."""
    d = x.shape[-1]
    if not (x.is_cuda and gamma.device == x.device):
        raise ValueError(f"rmsnorm: x on {x.device}, gamma on {gamma.device}: both must be on "
                         f"one CUDA device")
    if x.dtype not in _DTYPE_CODE or gamma.dtype != torch.float32:
        raise ValueError(f"rmsnorm: takes x float32 or bfloat16 and gamma float32, got "
                         f"{x.dtype} and {gamma.dtype}")
    if gamma.numel() != d or x.numel() == 0:
        raise ValueError(f"rmsnorm: x {tuple(x.shape)} and gamma {tuple(gamma.shape)}: want "
                         f"gamma of the last dim")
    x2, g = x.contiguous(), gamma.contiguous()
    out = torch.empty_like(x2)
    status = build.library().zgml_rmsnorm(
        _DTYPE_CODE[x.dtype], x2.data_ptr(), g.data_ptr(), out.data_ptr(), x.numel() // d, d,
        float(eps), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "rmsnorm")
    global_profile.count_op("rmsnorm", "cuda")
    return out


class RMSNorm(torch.autograd.Function):
    """``apply(x, gamma, eps, kernel)``: K12 where `kernel` is true, else the
    plain version (counted as a "ref" placement); the backward recomputes
    refs.rmsnorm under autograd on the saved x and gamma, on either tier,
    counted as "rmsnorm_bwd" plain torch by design."""

    @staticmethod
    def forward(ctx, x, gamma, eps, kernel):
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        if kernel:
            return rmsnorm_cuda(x, gamma, eps)
        global_profile.count_op("rmsnorm", "ref")
        return rmsnorm_ref(x, gamma, eps)

    @staticmethod
    def backward(ctx, g):
        x, gamma = ctx.saved_tensors
        global_profile.count_op("rmsnorm_bwd", "torch")
        with torch.enable_grad():
            xl, gl = x.detach().requires_grad_(), gamma.detach().requires_grad_()
            dx, dg = torch.autograd.grad(rmsnorm_ref(xl, gl, ctx.eps), (xl, gl), g)
        return dx, dg, None, None
