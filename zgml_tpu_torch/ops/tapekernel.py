"""K15: the tape-streamed whole-stack decode megacall and its plain version.

Counterpart of zgml_tpu/ops/tapekernel.py: `build_tape` (the view that
LlamaModel.enable_tape_decode() attaches) and `_tape_kernel` through
`tape_decode_step` (pallas_call at line 553), which the JAX package runs for
a batch-1 decode token over the stacked bf16 cache where the view is
attached and ZGML_TPU_TAPE_DECODE is on, before K14 (models/llama.py:753-763),
over the stacked bf16 or f32 cache (stackkernel.py's layouts).

Its layer sequence is K14's (ops/stackkernel.py). Its numerics are not, as
the JAX kernel's code has them (`_deq_rows`, tapekernel.py:217-234, and the
`.astype(mxu)` calls at :319-323, 428-431, 451): under ZGML_TPU_TAPE_BF16
(on by default) every weight element is bf16_rn(level * bf16_rn(scale))
(bf16_weight) and each operand row of a projection, the normed x, the
attention output, the second normed x and the SwiGLU activation, is
bf16_rn(x); products are exact in f32 and summed in f32, and attention, the
norms and the residuals stay f32. With ZGML_TPU_TAPE_BF16=0 every operand is
f32, which is K14's function. (The JAX module docstring says the tape
quantizes activations to int8 in-kernel; its code does not, and the port
follows the code.)

The JAX tape is a flat copy of every weight cut into 512-lane entries for
one hand-DMA'd VMEM window, a layout that answers the TPU's VMEM and DMA
limits; the port keeps none of it. `build_tape` applies the JAX acceptance
rules and returns a Tape over ops/stackkernel.StackedLayers' pointer table
into the one resident copy, with the entry geometry the JAX Tape carries
(`dims`, for the checks). One kernel serves K14 and K15:
csrc/stack_decode.cu, templated on its operand rounding.
"""
from __future__ import annotations

import torch

from zgml_tpu_torch import config
from zgml_tpu_torch.ops import decode_plan, refs, stackkernel
from zgml_tpu_torch.quant.packed import PackedWeight
from zgml_tpu_torch.runtime.profile import global_profile

LANES = 512          # the JAX tape's entry width (tapekernel.py:61)


class Tape:
    """K15's view: `stack`, the StackedLayers pointer table it launches with,
    and `dims`, the JAX Tape's entry geometry (dp, n_qkv, fp, fp_pad, nAc, nC,
    nGU, nDN, nrow, dpg, EPL, L) of tapekernel.py:202-204."""

    def __init__(self, stack: stackkernel.StackedLayers, dims: tuple[int, ...]):
        self.stack = stack
        self.dims = dims


def build_tape(params: dict, cfg) -> Tape | None:
    """The K15 view of params' layer list, or None exactly where the JAX
    `build_tape` (tapekernel.py:91-139) returns None: besides the views both
    megacalls need (stackkernel.q4_views), on the JAX package's padded widths
    (config.padded_k and tile_friendly_pad, as its loader pads), the padded d
    a multiple of 1024 and equal to hq * hd, head_dim a multiple of 64 that
    divides 512, and the fused QKV width (unpadded), the padded d_ff and half
    the padded d each a multiple of 512."""
    layers = params.get("layers")
    if not isinstance(layers, (list, tuple)) or not layers:
        return None
    if not stackkernel.q4_views(cfg, layers):
        return None
    hq, hkv, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    dp = config.padded_k(d, "q4_0")
    r = dp // 2
    n_qkv = (hq + 2 * hkv) * hd
    if (dp % (2 * LANES) or hd % 64 or LANES % hd or hq * hd != dp
            or n_qkv % LANES or r % 32):
        return None
    fp = config.padded_k(cfg.d_ff, "q4_0")      # the N-packed FFN's padded width
    if fp % LANES or (dp // 2) % LANES:
        return None
    # the per-layer rules: wqkv unpadded along N, wo padded to dp along N
    if config.tile_friendly_pad(n_qkv) != n_qkv or config.tile_friendly_pad(d) != dp:
        return None
    n_ac, n_c, n_gu = n_qkv // LANES, dp // LANES, fp // LANES
    nrow = -(-fp // r)
    dpg = (dp // 2) // LANES
    n_dn = dpg * nrow
    dims = (dp, n_qkv, fp, nrow * r, n_ac, n_c, n_gu, n_dn, nrow, dpg,
            n_ac + n_c + 2 * n_gu + n_dn, len(layers))
    return Tape(stackkernel.StackedLayers(layers, hq, hkv, cfg.rms_norm_eps), dims)


def bf16_weight(w: PackedWeight) -> torch.Tensor:
    """f32 [n, k] holding K15's weights, bf16_rn(level * bf16_rn(d)) per
    element (`_deq_rows` with dt bf16: the f32 product of a level and a bf16
    is exact, so it rounds once)."""
    s = w.d.to(torch.float32).to(torch.bfloat16).to(torch.float32)
    v = w.levels().to(torch.float32) * s[..., None]
    return v.to(torch.bfloat16).to(torch.float32).reshape(w.n, w.k)


def bf16_matmul(x: torch.Tensor, w: PackedWeight) -> torch.Tensor:
    """bf16_rn(x) [..., K] @ bf16_weight(W).T -> f32 [..., N] (exact products,
    f32 sums)."""
    lead = x.shape[:-1]
    xb = x.reshape(-1, x.shape[-1]).to(torch.float32).to(torch.bfloat16).to(torch.float32)
    return (xb @ bf16_weight(w).T).reshape(*lead, w.n)


def tape_decode_ref(x: torch.Tensor, tape: Tape, ck: torch.Tensor, cv: torch.Tensor, pos,
                    cos: torch.Tensor, sin: torch.Tensor, bf16: bool = True):
    """K15's plain version: K14's (stackkernel.stacked_decode_ref) with every
    projection through bf16_matmul, or with f32 operands (bf16 False,
    ZGML_TPU_TAPE_BF16=0). Same contract as stacked_decode_ref."""
    mm = bf16_matmul if bf16 else refs.qmatmul_ref
    return stackkernel.stacked_decode_ref(x, tape.stack, ck, cv, pos, cos, sin, mm=mm)


def counter(bf16: bool, kv: int = decode_plan.KV_BF16) -> str:
    """K15's placement counter: tape_decode, or tape_decode_f32 under
    ZGML_TPU_TAPE_BF16=0; each + _f32kv over the f32 cache (kv
    decode_plan.KV_F32, stackkernel.kv_form)."""
    return (("tape_decode" if bf16 else "tape_decode_f32")
            + ("_f32kv" if kv == decode_plan.KV_F32 else ""))


def tape_decode_cuda(x: torch.Tensor, tape: Tape, ck: torch.Tensor, cv: torch.Tensor,
                     pos: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, bf16: bool = True):
    """Launch K15 (csrc/stack_decode.cu with bf16 operands, or f32 ones with
    bf16 False) over the bf16 or the f32 cache; counted under counter(bf16,
    stackkernel.kv_form(ck))."""
    out = stackkernel.launch(x, tape.stack, ck, cv, pos, cos, sin, bf16_ops=bf16)
    global_profile.count_op(counter(bf16, stackkernel.kv_form(ck)), "cuda")
    return out
