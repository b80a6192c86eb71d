"""Q4_0 matmul kernels and their plain versions.

  K2  q4_matmul_cuda / q4_matmul_ref        (csrc/q4_matmul.cu) counterpart of
      zgml_tpu/ops/qmatmul.py `_q4_kernel`: f32 dequant, any M.
  K1  q4_matmul_i8_cuda / q4_matmul_i8_ref  (csrc/q4_i8_matmul.cu) counterpart
      of `_q4_i8_kernel`: int8 activations per 32-block, exact int8 x int4
      block dots, f32 scale and sum; the tier for M <= 32.
  K5  q4_greedy_cuda / q4_greedy_ref        (csrc/q4_i8_matmul.cu) counterpart
      of `_q4_i8_argmax_kernel` / `qmatmul_greedy_pallas`: K1 on one row,
      then the argmax id (first index on ties).

Callers go through ``ops.dispatch``, which picks the tier (config.i8dot(),
M) and between kernel and plain version by device.
"""
from __future__ import annotations

import torch

from zgml_tpu_torch.ops import build, refs
from zgml_tpu_torch.quant.blocks import QK
from zgml_tpu_torch.quant.packed import PackedWeight
from zgml_tpu_torch.runtime.profile import global_profile

q4_matmul_ref = refs.qmatmul_ref

I8_MAX_ROWS = 32        # K1 serves M <= 32 (zgml_tpu/ops/qmatmul.py:639,728)


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"q4_matmul: {msg}")


def _check(x: torch.Tensor, w: PackedWeight):
    _require(x.is_cuda and w.qs.device == x.device and w.d.device == x.device,
             f"x on {x.device}, weight on {w.qs.device}: all must be on one CUDA device")
    _require(x.dtype == torch.float32, f"x must be float32, got {x.dtype}")
    _require(x.shape[-1] == w.k, f"x has K={x.shape[-1]}, weight K={w.k}")
    _require(x.is_contiguous() and w.qs.is_contiguous() and w.d.is_contiguous(),
             "x and the weight planes must be contiguous")
    _require(x.data_ptr() % 16 == 0 and w.qs.data_ptr() % 16 == 0,
             "x and qs must be 16-byte aligned")


def q4_matmul_cuda(x: torch.Tensor, w: PackedWeight) -> torch.Tensor:
    """K2: x f32 [..., K] (contiguous, on the card) @ dequant(W).T -> f32 [..., N]."""
    _check(x, w)
    lead = x.shape[:-1]
    m = x.numel() // w.k
    y = torch.empty((*lead, w.n), dtype=torch.float32, device=x.device)
    if m == 0:
        return y
    status = build.library().zgml_q4_matmul(
        x.data_ptr(), w.qs.data_ptr(), w.d.data_ptr(), y.data_ptr(), m, w.n, w.k,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "q4_matmul")
    global_profile.count_op("qmatmul", "cuda")
    return y


# -- K1 / K5: the int8-activation tier -----------------------------------------

def quantize_act_ref(x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x f32 [M, K] -> (xq int8 [M, K], xs f32 [M, K/32]) as the JAX
    `_quantize_act` (qmatmul.py:181-190): s = amax/127, inv = 1/s (0 where
    s == 0), xq = clip(round_half_even(x * inv), -127, 127)."""
    m, k = x2.shape
    xb = x2.to(torch.float32).reshape(m, k // QK, QK)
    amax = xb.abs().amax(dim=-1)
    # tensor / tensor: a true division on every device (on CUDA, torch turns
    # division by a Python scalar into a multiply by its reciprocal)
    s = amax / torch.full_like(amax, 127.0)
    one = torch.ones_like(s)
    inv = torch.where(s > 0, one / torch.where(s > 0, s, one), torch.zeros_like(s))
    q = torch.clamp(torch.round(xb * inv[..., None]), -127, 127).to(torch.int8)
    return q.reshape(m, k), s


def q4_matmul_i8_ref(x: torch.Tensor, w: PackedWeight) -> torch.Tensor:
    """K1's plain version: x f32 [..., K] -> f32 [..., N]. The block dots are
    taken in f32 on integers below 2^24, so they are exact, as on the card."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, w.k)
    xq, xs = quantize_act_ref(x2)
    nb = w.k // QK
    q = w.qs.view(w.n, nb, 16)
    wv = torch.cat([q & 0x0F, q >> 4], dim=-1).to(torch.float32) - 8.0    # [N, nb, 32]
    p = torch.einsum("mbj,nbj->mnb", xq.view(-1, nb, QK).to(torch.float32), wv)
    y = (p * (xs[:, None, :] * w.d.to(torch.float32)[None])).sum(dim=-1)
    return y.reshape(*lead, w.n)


def q4_greedy_ref(x: torch.Tensor, w: PackedWeight) -> torch.Tensor:
    """K5's plain version: one row x [..., K] -> int64 [1], the first argmax
    of q4_matmul_i8_ref(x, w)."""
    return torch.argmax(q4_matmul_i8_ref(x.reshape(1, w.k), w)[0]).reshape(1)


def _i8_scratch(m: int, k: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """xq int8 [m, k] and xs f32 [m, k/32] for the pre-pass."""
    return (torch.empty((m, k), dtype=torch.int8, device=device),
            torch.empty((m, k // QK), dtype=torch.float32, device=device))


def quantize_act_cuda(x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's activation pre-pass alone, on the card: x f32 [M, K] -> (xq, xs),
    bit-equal to quantize_act_ref (so a check can hold it to the plain one)."""
    _require(x2.is_cuda and x2.dtype == torch.float32 and x2.dim() == 2
             and x2.is_contiguous() and x2.shape[1] % QK == 0,
             f"x must be a contiguous float32 [M, K % 32 == 0] CUDA tensor, got "
             f"{x2.dtype} {tuple(x2.shape)} on {x2.device}")
    xq, xs = _i8_scratch(*x2.shape, x2.device)
    status = build.library().zgml_q4_i8_quantize(
        x2.data_ptr(), xq.data_ptr(), xs.data_ptr(), x2.shape[0], x2.shape[1],
        torch.cuda.current_stream(x2.device).cuda_stream)
    build.check(status, "q4_i8_quantize")
    return xq, xs


def q4_matmul_i8_cuda(x: torch.Tensor, w: PackedWeight) -> torch.Tensor:
    """K1: x f32 [..., K] with at most 32 rows -> f32 [..., N]."""
    _check(x, w)
    lead = x.shape[:-1]
    m = x.numel() // w.k
    _require(m <= I8_MAX_ROWS, f"the int8 tier takes M <= {I8_MAX_ROWS} rows, got {m}")
    y = torch.empty((*lead, w.n), dtype=torch.float32, device=x.device)
    if m == 0:
        return y
    xq, xs = _i8_scratch(m, w.k, x.device)
    status = build.library().zgml_q4_matmul_i8(
        x.data_ptr(), xq.data_ptr(), xs.data_ptr(), w.qs.data_ptr(), w.d.data_ptr(),
        y.data_ptr(), m, w.n, w.k, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "q4_matmul_i8")
    global_profile.count_op("qmatmul_i8", "cuda")
    return y


def q4_greedy_cuda(x: torch.Tensor, w: PackedWeight) -> torch.Tensor:
    """K5: one row x f32 [..., K] -> int64 [1] on the card, equal to
    argmax(q4_matmul_i8_cuda(x, w)) (same per-row device code)."""
    _check(x, w)
    _require(x.numel() == w.k, f"the greedy head takes one row, got {tuple(x.shape)}")
    xq, xs = _i8_scratch(1, w.k, x.device)
    ws = torch.empty(2, dtype=torch.int64, device=x.device)     # zeroed by the pre-pass
    out = torch.empty(1, dtype=torch.int64, device=x.device)
    status = build.library().zgml_q4_greedy(
        x.data_ptr(), xq.data_ptr(), xs.data_ptr(), w.qs.data_ptr(), w.d.data_ptr(),
        ws.data_ptr(), out.data_ptr(), w.n, w.k,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "q4_greedy")
    global_profile.count_op("qmatmul_greedy", "cuda")
    return out
