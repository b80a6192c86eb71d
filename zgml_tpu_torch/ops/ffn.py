"""K6: the fused FFN (rmsnorm + gate|up + SwiGLU + down + residual) and its
plain version, Q4_0 (K6d) or Q8_0 (K6a).

Counterpart of zgml_tpu/ops/ffn.py `_ffn_q4n_kernel` / `fused_ffn_norm_q4n`
(K6d, Q4_0) and `_ffn_kernel` / `fused_ffn_norm_pallas` (K6a, Q8_0), f32
dequant. The JAX kernels read an N-packed (Q4_0, quant/headmajor.py
ffn_npack) or planar part-padded (Q8_0) copy of the FFN weights; the port
reads its one resident copy: ``w_gate_up`` [2F, D] (gate rows, then up rows)
and ``w_down`` [D, F], on the logical sizes (no padding). At most 32 rows, as
the JAX dispatch (zgml_tpu/ops/dispatch.py:95-139). Callers go through
``ops.dispatch.fused_ffn_norm``; ``ffn_fuses`` says where the JAX package
fuses the FFN at all.
"""
from __future__ import annotations

import torch

from zgml_tpu_torch.ops import build, coop, refs
from zgml_tpu_torch.ops.qmatmul import KIND_CODE, counter
from zgml_tpu_torch.quant.packed import PackedWeight
from zgml_tpu_torch.runtime.profile import global_profile

FFN_MAX_ROWS = 32
FFN_MAX_DP = 8192        # ffn_compatible's padded-D cap (zgml_tpu/ops/ffn.py:556)


def _tile_friendly_pad(x: int) -> int:
    """The JAX package's padded size of a weight dim
    (zgml_tpu/quant/repack.py _tile_friendly_pad)."""
    for align in (1024, 512, 256, 128):
        p = -(-x // align) * align
        if p - x <= max(align // 4, 0.08 * x):
            return p
    return -(-x // 128) * 128


def ffn_fuses(d_model: int, d_ff: int, kind: str, after_attn_block: bool) -> bool:
    """Whether the JAX package runs a fused FFN kernel at this width and
    kind, on weights its loader pads (repack.py: every dim to
    _tile_friendly_pad; Q4_0 K further to a multiple of 512, Q8_0 K to one
    of 32; w_gate_up's halves part-padded to w_down's padded K).

      q4_0  its fused FFN kernels need w_down's padded D rows equal to
            w_gate_up's padded D columns, i.e. the padded D a multiple of 512
            (the N-packed view, quant/headmajor.py:287-292; ffn_compatible,
            ops/ffn.py:550-564). After the layer kernel the N-packed K6d
            takes any such D (`_ffn_after_attn`); in `_layer_step`
            ffn_compatible also caps the padded D at 8192.
      q8_0  no N-packed view is attached, so both call sites go through
            ffn_compatible's Q8 branch (ops/ffn.py:550-559): the padded D at
            most 8192 and w_down's padded K (from F) a multiple of 256.

    The port pads nothing; it only takes the same path."""
    dp = _tile_friendly_pad(d_model)
    if kind == "q8_0":
        return dp <= FFN_MAX_DP and _tile_friendly_pad(d_ff) % 256 == 0
    return dp % 512 == 0 and (after_attn_block or dp <= FFN_MAX_DP)


def fused_ffn_norm_ref(x: torch.Tensor, gamma: torch.Tensor, gu: PackedWeight,
                       wd: PackedWeight, eps: float) -> torch.Tensor:
    """x + down(silu(gate(n)) * up(n)), n = rmsnorm(x) * gamma; x f32 [..., D]."""
    h = refs.rmsnorm(x, gamma, eps)
    g_u = refs.qmatmul_ref(h, gu)
    f = gu.n // 2
    return x + refs.qmatmul_ref(refs.swiglu(g_u[..., :f], g_u[..., f:]), wd)


def fused_ffn_norm_cuda(x: torch.Tensor, gamma: torch.Tensor, gu: PackedWeight,
                        wd: PackedWeight, eps: float) -> torch.Tensor:
    """Launch K6d (Q4_0) or K6a (Q8_0), csrc/ffn.cu. x f32 [..., D] with at
    most 32 rows; both weights of one kind."""
    def require(cond, msg):
        if not cond:
            raise ValueError(f"fused_ffn_norm: {msg}")
    dev = x.device
    require(x.is_cuda and all(t.device == dev for t in (gamma, gu.qs, gu.d, wd.qs, wd.d)),
            f"x on {x.device}: x, gamma and the weights must be on one CUDA device")
    require(x.dtype == torch.float32 and gamma.dtype == torch.float32,
            f"x and gamma must be float32, got {x.dtype}/{gamma.dtype}")
    require(gu.kind == wd.kind, f"w_gate_up is {gu.kind}, w_down {wd.kind}: one kind")
    d, f = x.shape[-1], wd.k
    require(gu.k == d and gu.n == 2 * f and wd.n == d and gamma.numel() == d,
            f"shapes: x D={d}, w_gate_up [{gu.n}, {gu.k}], w_down [{wd.n}, {wd.k}], "
            f"gamma {gamma.numel()}; want [2F, D], [D, F], D")
    require(x.is_contiguous() and gamma.is_contiguous()
            and all(t.is_contiguous() for t in (gu.qs, gu.d, wd.qs, wd.d)),
            "x, gamma and the weight planes must be contiguous")
    require(gu.qs.data_ptr() % 16 == 0 and wd.qs.data_ptr() % 16 == 0,
            "the weights' qs planes must be 16-byte aligned")
    m = x.numel() // d
    require(0 < m <= FFN_MAX_ROWS, f"takes 1..{FFN_MAX_ROWS} rows, got {m}")
    y = torch.empty_like(x)
    act = torch.empty((m, f), dtype=torch.float32, device=dev)
    status = build.library().zgml_ffn_norm(
        KIND_CODE[gu.kind], x.data_ptr(), gamma.data_ptr(), gu.qs.data_ptr(), gu.d.data_ptr(),
        wd.qs.data_ptr(), wd.d.data_ptr(), y.data_ptr(), act.data_ptr(),
        coop.barrier_words(dev).data_ptr(),
        m, d, f, float(eps), torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, "fused_ffn_norm")
    global_profile.count_op(counter("fused_ffn_norm", gu.kind), "cuda")
    return y
