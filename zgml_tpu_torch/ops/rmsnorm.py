"""K12: the row rmsnorm kernel, its launch plan, its plain version, and its
autograd Function.

Counterpart of zgml_tpu/ops/rmsnorm.py (`_rmsnorm_kernel` / `_rmsnorm2d` /
`rmsnorm_pallas`): out = x * rsqrt(mean(x^2) + eps) * gamma over the last
dim, f32 math, out in x's dtype. ``rmsnorm_cuda`` launches csrc/rmsnorm.cu
(x f32 or bf16, gamma f32) on the plan of ``rmsnorm_plan``; ``rmsnorm_ref``
is refs.rmsnorm. ``RMSNorm`` joins them for autograd as the JAX custom VJP
does: the forward is K12 (or the plain version), the backward recomputes
refs.rmsnorm under autograd (rmsnorm.py:59-65).

Callers go through ``ops.dispatch.rmsnorm``, which takes K12 only where
ZGML_TPU_KERNELS_FORCE names "rmsnorm" (the JAX package's default there is
plain XLA, dispatch.py:144-155).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from zgml_tpu_torch.ops import build, refs
from zgml_tpu_torch.ops.attention import _sm_count
from zgml_tpu_torch.runtime.profile import global_profile

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

rmsnorm_ref = refs.rmsnorm

# csrc/rmsnorm.cu's limits: vectors a thread holds, threads a block, and the
# scalar path's threads a block
VEC_BYTES, VPT_MAX, THREADS_MAX, SCALAR_THREADS = 16, 4, 1024, 256
# rows that one warp holds (at most 32 * VPT_MAX vectors) go up to
# WARP_ROWS_MAX to a block
WARP_ROWS_MAX = 8


class RmsnormPlan(NamedTuple):
    """How K12 covers [m, d]. On the vector path thread t of a row's
    `threads` holds the row's vectors r * threads + t for r < vpt, those
    below d / width; on the scalar path (width 1) elements t, t + threads,
    ... (vpt of them at most)."""
    vector: bool     # the 16-byte vector path, else the scalar loop
    width: int       # values a vector holds: 4 f32, 8 bf16 (1: scalar)
    vpt: int         # vectors (scalar path: values) a thread holds
    threads: int     # threads a row takes in a block (a multiple of 32)
    rows: int        # rows a block takes (> 1 only where a warp holds a row)
    blocks: int      # the grid


def _round32(n: int) -> int:
    return -(-n // 32) * 32


def rmsnorm_plan(m: int, d: int, dtype: torch.dtype, sm_count: int,
                 aligned: bool = True) -> RmsnormPlan:
    """K12's plan for m rows of d values of `dtype` on a card of sm_count
    SMs. The vector path where d is a multiple of the vector width, every
    operand is 16-byte aligned (`aligned`) and a row fits 1024 threads of 4
    vectors; else the scalar loop. A row of at most 32 * VPT_MAX vectors
    takes one warp, blocks of up to WARP_ROWS_MAX rows but not fewer blocks
    than SMs where there are rows for them; a wider row takes one block of
    the fewest threads that hold it in VPT_MAX vectors each."""
    width = VEC_BYTES // dtype.itemsize
    nvec = d // width
    if not aligned or d % width or nvec > VPT_MAX * THREADS_MAX:
        threads = min(SCALAR_THREADS, _round32(d))
        return RmsnormPlan(False, 1, -(-d // threads), threads, 1, m)
    if nvec <= 32 * VPT_MAX:
        rows = max(1, min(WARP_ROWS_MAX, m // sm_count))
        return RmsnormPlan(True, width, -(-nvec // 32), 32, rows, -(-m // rows))
    threads = _round32(-(-nvec // VPT_MAX))
    return RmsnormPlan(True, width, -(-nvec // threads), threads, 1, m)


def launch_plan(x: torch.Tensor, gamma: torch.Tensor) -> RmsnormPlan:
    """The plan rmsnorm_cuda takes for contiguous x and gamma on x's card
    (the output, fresh from torch.empty, is aligned)."""
    d = x.shape[-1]
    aligned = x.data_ptr() % VEC_BYTES == 0 and gamma.data_ptr() % VEC_BYTES == 0
    return rmsnorm_plan(x.numel() // d, d, x.dtype, _sm_count(x.device.index or 0), aligned)


def rmsnorm_cuda(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Launch K12: x f32 or bf16 [..., d], gamma f32 [d] -> out [..., d] in
    x's dtype, on launch_plan's plan."""
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
    plan = launch_plan(x2, g)
    status = build.library().zgml_rmsnorm(
        _DTYPE_CODE[x.dtype], x2.data_ptr(), g.data_ptr(), out.data_ptr(), x.numel() // d, d,
        float(eps), plan.vpt if plan.vector else 0, plan.threads, plan.rows,
        torch.cuda.current_stream(x.device).cuda_stream)
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
