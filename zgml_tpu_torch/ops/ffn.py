"""K6: the fused FFN kernels and their plain versions.

  K6d / K6a / K6c  fused_ffn_norm_cuda / fused_ffn_norm_ref (csrc/ffn.cu):
      x + down(silu(gate(n)) * up(n)), n = rmsnorm(x) * gamma (norm and
      residual inside). Counterpart of zgml_tpu/ops/ffn.py `_ffn_q4n_kernel`
      / `fused_ffn_norm_q4n` (K6d, Q4_0, f32 dequant), its int8 gate|up mode
      `_ffn_q4n_i8_kernel` (K6c, Q4_0, where config.ffn_i8a(dp) holds: by
      default at padded d >= 4096) and `_ffn_kernel` / `fused_ffn_norm_pallas`
      (K6a, Q8_0, f32). The fused batch-1 decode runs it after K7; at Q8_0
      also `_layer_step`.
  K6b  fused_ffn_cuda / fused_ffn_ref (csrc/ffn_planar.cu): down(silu(gate(h))
      * up(h)) for an already-normed h, no residual, Q4_0, f32. Counterpart of
      `_ffn_q4_kernel` / `fused_ffn_pallas`, which the JAX `_layer_step` runs
      (through dispatch.fused_ffn) for Q4_0 FFN calls of <= 32 rows.

The JAX kernels read an N-packed (Q4_0 decode, quant/headmajor.py
ffn_npack) or planar part-padded copy of the FFN weights; the port reads its
one resident copy: ``w_gate_up`` [2F, D] (gate rows, then up rows) and
``w_down`` [D, F], on the logical sizes (no padding). At most 32 rows, as the
JAX dispatch (zgml_tpu/ops/dispatch.py:95-139). Callers go through
``ops.dispatch``; ``ffn_fuses`` says where the JAX package fuses the FFN at
all.

K6c quantizes n per 32-block like K1 (qmatmul.rmsnorm_quantize_ref); a check
can pass `act_out` to the kernel and `act` to the plain version to hold both
to the same int8 activations.
"""
from __future__ import annotations

import torch

from zgml_tpu_torch import config
from zgml_tpu_torch.ops import build, coop, refs
from zgml_tpu_torch.ops.qmatmul import KIND_CODE, counter, i8_dot_ref, rmsnorm_quantize_ref
from zgml_tpu_torch.quant.packed import PackedWeight
from zgml_tpu_torch.runtime.profile import global_profile

FFN_MAX_ROWS = 32
FFN_MAX_DP = 8192        # ffn_compatible's padded-D cap (zgml_tpu/ops/ffn.py:556)


def ffn_fuses(d_model: int, d_ff: int, kind: str, after_attn_block: bool) -> bool:
    """Whether the JAX package runs a fused FFN kernel at this width and
    kind, on weights its loader pads (repack.py: every dim to
    tile_friendly_pad; Q4_0 K further to a multiple of 512, Q8_0 K to one
    of 32; w_gate_up's halves part-padded to w_down's padded K).

      q4_0  its fused FFN kernels need w_down's padded D rows equal to
            w_gate_up's padded D columns, i.e. the padded D a multiple of 512
            (the N-packed view, quant/headmajor.py:287-292; ffn_compatible,
            ops/ffn.py:550-564). After the layer kernel the N-packed K6d / K6c
            takes any such D (`_ffn_after_attn`); in `_layer_step` (K6b)
            ffn_compatible also caps the padded D at 8192.
      q8_0  no N-packed view is attached, so both call sites go through
            ffn_compatible's Q8 branch (ops/ffn.py:550-559): the padded D at
            most 8192 and w_down's padded K (from F) a multiple of 256.

    The port pads nothing; it only takes the same path."""
    dp = config.tile_friendly_pad(d_model)
    if kind == "q8_0":
        return dp <= FFN_MAX_DP and config.tile_friendly_pad(d_ff) % 256 == 0
    return dp % 512 == 0 and (after_attn_block or dp <= FFN_MAX_DP)


def fused_ffn_norm_ref(x: torch.Tensor, gamma: torch.Tensor, gu: PackedWeight,
                       wd: PackedWeight, eps: float, a_i8: bool = False,
                       act=None) -> torch.Tensor:
    """x + down(silu(gate(n)) * up(n)), n = rmsnorm(x) * gamma; x f32 [..., D].
    a_i8 (K6c): gate|up as K1's int8 block dots on `act` = (xq, xs) when
    given, else on rmsnorm_quantize_ref's."""
    if a_i8:
        xq, xs = rmsnorm_quantize_ref(x, gamma, eps) if act is None else act
        d = x.shape[-1]
        g_u = i8_dot_ref(xq.reshape(-1, d), xs.reshape(-1, d // 32), gu)
        g_u = g_u.reshape(*x.shape[:-1], gu.n)
    else:
        g_u = refs.qmatmul_ref(refs.rmsnorm(x, gamma, eps), gu)
    f = gu.n // 2
    return x + refs.qmatmul_ref(refs.swiglu(g_u[..., :f], g_u[..., f:]), wd)


def fused_ffn_ref(h: torch.Tensor, gu: PackedWeight, wd: PackedWeight) -> torch.Tensor:
    """K6b's plain version: down(silu(gate(h)) * up(h)); h f32 [..., D]."""
    g_u = refs.qmatmul_ref(h, gu)
    f = gu.n // 2
    return refs.qmatmul_ref(refs.swiglu(g_u[..., :f], g_u[..., f:]), wd)


def _check(name: str, x: torch.Tensor, others, gu: PackedWeight, wd: PackedWeight) -> int:
    """The wrappers' argument checks; returns the row count."""
    def require(cond, msg):
        if not cond:
            raise ValueError(f"{name}: {msg}")
    dev = x.device
    require(x.is_cuda and all(t.device == dev for t in (*others, gu.qs, gu.d, wd.qs, wd.d)),
            f"x on {x.device}: every tensor and weight must be on one CUDA device")
    require(x.dtype == torch.float32 and all(t.dtype == torch.float32 for t in others),
            f"x and gamma must be float32, got {x.dtype}")
    require(gu.kind == wd.kind, f"w_gate_up is {gu.kind}, w_down {wd.kind}: one kind")
    d, f = x.shape[-1], wd.k
    require(gu.k == d and gu.n == 2 * f and wd.n == d and all(t.numel() == d for t in others),
            f"shapes: x D={d}, w_gate_up [{gu.n}, {gu.k}], w_down [{wd.n}, {wd.k}]; "
            f"want [2F, D], [D, F] (and gamma D)")
    require(x.is_contiguous() and all(t.is_contiguous() for t in others)
            and all(t.is_contiguous() for t in (gu.qs, gu.d, wd.qs, wd.d)),
            "x, gamma and the weight planes must be contiguous")
    require(gu.qs.data_ptr() % 16 == 0 and wd.qs.data_ptr() % 16 == 0,
            "the weights' qs planes must be 16-byte aligned")
    m = x.numel() // d
    require(0 < m <= FFN_MAX_ROWS, f"takes 1..{FFN_MAX_ROWS} rows, got {m}")
    return m


def fused_ffn_norm_cuda(x: torch.Tensor, gamma: torch.Tensor, gu: PackedWeight,
                        wd: PackedWeight, eps: float, a_i8: bool = False,
                        act_out=None) -> torch.Tensor:
    """Launch K6d (Q4_0), K6a (Q8_0) or, with a_i8, K6c (Q4_0 only),
    csrc/ffn.cu. x f32 [..., D] with at most 32 rows; both weights of one
    kind. act_out = (xq int8 [M, D], xs f32 [M, D/32]) receives K6c's
    activations where given."""
    m = _check("fused_ffn_norm", x, (gamma,), gu, wd)
    dev, d, f = x.device, x.shape[-1], wd.k
    if a_i8 and gu.kind != "q4_0":
        raise ValueError(f"fused_ffn_norm: the int8 mode takes q4_0 weights, got {gu.kind}")
    xq_p = xs_p = None
    if act_out is not None:
        if not (a_i8 and act_out[0].dtype == torch.int8 and act_out[0].numel() == m * d
                and act_out[1].dtype == torch.float32 and act_out[1].numel() == m * d // 32
                and all(t.device == dev and t.is_contiguous() for t in act_out)):
            raise ValueError(f"fused_ffn_norm: act_out takes int8 [{m}, {d}] and float32 "
                             f"[{m}, {d // 32}] on {dev}, with a_i8")
        xq_p, xs_p = act_out[0].data_ptr(), act_out[1].data_ptr()
    y = torch.empty_like(x)
    act = torch.empty((m, f), dtype=torch.float32, device=dev)
    status = build.library().zgml_ffn_norm(
        KIND_CODE[gu.kind], int(a_i8), x.data_ptr(), gamma.data_ptr(), gu.qs.data_ptr(),
        gu.d.data_ptr(), wd.qs.data_ptr(), wd.d.data_ptr(), y.data_ptr(), act.data_ptr(),
        coop.barrier_words(dev).data_ptr(), xq_p, xs_p,
        m, d, f, float(eps), torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, "fused_ffn_norm")
    name = "fused_ffn_norm_i8" if a_i8 else "fused_ffn_norm"
    global_profile.count_op(counter(name, gu.kind), "cuda")
    return y


def fused_ffn_cuda(h: torch.Tensor, gu: PackedWeight, wd: PackedWeight) -> torch.Tensor:
    """Launch K6b (csrc/ffn_planar.cu): h f32 [..., D] (normed) with at most
    32 rows, Q4_0 weights -> down(silu(gate(h)) * up(h)) f32 [..., D]."""
    m = _check("fused_ffn", h, (), gu, wd)
    if gu.kind != "q4_0":
        raise ValueError(f"fused_ffn: K6b takes q4_0 weights, got {gu.kind}")
    dev, d, f = h.device, h.shape[-1], wd.k
    y = torch.empty_like(h)
    act = torch.empty((m, f), dtype=torch.float32, device=dev)
    status = build.library().zgml_ffn(
        KIND_CODE[gu.kind], h.data_ptr(), gu.qs.data_ptr(), gu.d.data_ptr(), wd.qs.data_ptr(),
        wd.d.data_ptr(), y.data_ptr(), act.data_ptr(), coop.barrier_words(dev).data_ptr(),
        m, d, f, torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, "fused_ffn")
    global_profile.count_op("fused_ffn", "cuda")
    return y
