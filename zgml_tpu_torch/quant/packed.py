"""The port's packed weight: N-major, GGUF block order, fp16 scales, Q4_0 or Q8_0.

Counterpart of zgml_tpu/quant/repack.py. The JAX package re-lays GGUF blocks
out K-major (with a global K half-split for Q4_0) for the TPU's lanes; the
port keeps the GGUF order instead, split into two planes:

  kind "q4_0"
    qs  uint8   [N, K/2]   row n = the 16 nibble bytes of each of its K/32
                           blocks, in order (byte j of a block holds element j
                           in the low nibble and element j+16 in the high one);
                           value = (nibble - 8) * d as in ggml
  kind "q8_0"
    qs  int8    [N, K]     row n = the 32 int8 of each of its K/32 blocks, in
                           order; value = q * d
  both
    d   float16 [N, K/32]  the blocks' scales, bit-exact to the file

so one output row is contiguous along K (a warp of the GEMV reads it in
16-byte pieces), loading is a split of each 18- or 34-byte block with no
transpose, and every qs row is 16-byte aligned (K % 32 == 0 gives it).

The from_* functions put their weight on the card unless the caller asks
for the CPU (device="cpu", which runs the plain torch versions).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from zgml_tpu_torch.quant.blocks import QK, Q4_0_BLOCK_BYTES, Q8_0_BLOCK_BYTES

KINDS = ("q4_0", "q8_0")
# qs bytes per 32-element block of each kind
QS_BLOCK_BYTES = {"q4_0": 16, "q8_0": 32}
_QS_DTYPE = {"q4_0": torch.uint8, "q8_0": torch.int8}


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device on a machine without one
    raises here, so a default-argument call never hands back a CPU model."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for, but torch sees no CUDA device: pass "
            f"device='cpu' to run the plain torch versions on the CPU")
    return dev


@dataclasses.dataclass
class PackedWeight:
    """A Q4_0 or Q8_0 weight for ``x @ dequant(W).T``: n = out features, k = in."""
    n: int
    k: int
    qs: torch.Tensor     # uint8 [n, k // 2] (q4_0) or int8 [n, k] (q8_0)
    d: torch.Tensor      # float16 [n, k // 32]
    kind: str = "q4_0"

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"PackedWeight kind {self.kind!r} not in {KINDS}")
        if self.k % QK:
            raise ValueError(f"K={self.k} not divisible by {QK}")
        qs_cols = self.k // QK * QS_BLOCK_BYTES[self.kind]
        if (tuple(self.qs.shape) != (self.n, qs_cols) or self.qs.dtype != _QS_DTYPE[self.kind]
                or tuple(self.d.shape) != (self.n, self.k // QK)
                or self.d.dtype != torch.float16):
            raise ValueError(
                f"PackedWeight {self.kind} planes {tuple(self.qs.shape)} {self.qs.dtype}, "
                f"{tuple(self.d.shape)} {self.d.dtype} do not match n={self.n} k={self.k}")

    def levels(self) -> torch.Tensor:
        """int16 [n, k/32, 32]: each element's integer level in natural order
        (nibble - 8 for q4_0, q for q8_0)."""
        nb = self.k // QK
        if self.kind == "q8_0":
            return self.qs.view(self.n, nb, QK).to(torch.int16)
        q = self.qs.view(self.n, nb, 16)
        return torch.cat([q & 0x0F, q >> 4], dim=-1).to(torch.int16) - 8

    def dequant(self) -> torch.Tensor:
        """f32 [n, k]: the exact dequantized values (the plain version's weight)."""
        w = self.levels().to(torch.float32)                       # [n, k/32, 32]
        return (w * self.d.to(torch.float32)[..., None]).reshape(self.n, self.k)


def _split_blocks(raw: np.ndarray, n: int, k: int, block_bytes: int):
    if k % QK:
        raise ValueError(f"K={k} not divisible by {QK}")
    nb = n * k // QK
    blk = np.asarray(raw, dtype=np.uint8).reshape(-1)[: nb * block_bytes]
    blk = blk.reshape(n, k // QK, block_bytes)
    d = np.ascontiguousarray(blk[:, :, :2]).view(np.float16).reshape(n, k // QK)
    return np.ascontiguousarray(blk[:, :, 2:]), d


def from_gguf_q4_0(raw: np.ndarray, n: int, k: int, device="cuda") -> PackedWeight:
    """Raw GGUF Q4_0 bytes of an [n, k] weight -> PackedWeight on `device`."""
    dev = resolve_device(device)
    qs, d = _split_blocks(raw, n, k, Q4_0_BLOCK_BYTES)
    return PackedWeight(n, k, torch.from_numpy(qs.reshape(n, k // 2)).to(dev),
                        torch.from_numpy(d).to(dev))


def from_gguf_q8_0(raw: np.ndarray, n: int, k: int, device="cuda") -> PackedWeight:
    """Raw GGUF Q8_0 bytes of an [n, k] weight -> PackedWeight on `device`
    (each 34-byte block splits into its scale and its 32 int8)."""
    dev = resolve_device(device)
    qs, d = _split_blocks(raw, n, k, Q8_0_BLOCK_BYTES)
    return PackedWeight(n, k, torch.from_numpy(qs.view(np.int8).reshape(n, k)).to(dev),
                        torch.from_numpy(d).to(dev), "q8_0")


def from_nibbles(nib: np.ndarray, d: np.ndarray, device="cuda") -> PackedWeight:
    """Unsigned nibbles uint8 [n, k] (natural element order) and f16 scales
    [n, k/32] -> Q4_0 PackedWeight (the block byte order is built here)."""
    dev = resolve_device(device)
    n, k = nib.shape
    b = np.asarray(nib, dtype=np.uint8).reshape(n, k // QK, QK)
    qs = (b[:, :, :16] | (b[:, :, 16:] << 4)).reshape(n, k // 2)
    d = np.asarray(d, dtype=np.float16).reshape(n, k // QK)
    return PackedWeight(n, k, torch.from_numpy(np.ascontiguousarray(qs)).to(dev),
                        torch.from_numpy(np.ascontiguousarray(d)).to(dev))


def from_int8(q: np.ndarray, d: np.ndarray, device="cuda") -> PackedWeight:
    """int8 levels [n, k] (natural element order) and f16 scales [n, k/32]
    -> Q8_0 PackedWeight."""
    dev = resolve_device(device)
    n, k = q.shape
    d = np.asarray(d, dtype=np.float16).reshape(n, k // QK)
    return PackedWeight(n, k, torch.from_numpy(np.ascontiguousarray(q, dtype=np.int8)).to(dev),
                        torch.from_numpy(np.ascontiguousarray(d)).to(dev), "q8_0")


def planar_scales_f16(scales: np.ndarray) -> np.ndarray:
    """Block scales of the JAX planar layout in any of its storage dtypes
    (int16 holding f16 bits, bfloat16, float32) -> float16."""
    s = np.asarray(scales)
    if s.dtype == np.int16:
        return s.view(np.float16)
    return s.astype(np.float32).astype(np.float16)


def from_planar_q4_0(qvals: np.ndarray, scales: np.ndarray, n: int, k: int,
                     col0: int = 0, device="cuda") -> PackedWeight:
    """The JAX package's planar Q4_0 layout (half-split K-major qvals
    [k_pad/2, n_pad], scales [k_pad/32, n_pad]) -> PackedWeight of logical
    columns [col0, col0 + n) and rows [0, k)."""
    b = np.asarray(qvals).view(np.uint8)
    kh = b.shape[0]
    cols = slice(col0, col0 + n)
    nib = np.empty((2 * kh, n), np.uint8)
    nib[:kh] = b[:, cols] & 0x0F
    nib[kh:] = b[:, cols] >> 4
    s = planar_scales_f16(scales)[: k // QK, cols]
    return from_nibbles(np.ascontiguousarray(nib[:k].T), np.ascontiguousarray(s.T), device)


def from_planar_q8_0(qvals: np.ndarray, scales: np.ndarray, n: int, k: int,
                     col0: int = 0, device="cuda") -> PackedWeight:
    """The JAX package's planar Q8_0 layout (K-major qvals int8 [k_pad,
    n_pad], scales [k_pad/32, n_pad] in any storage dtype) -> PackedWeight of
    logical columns [col0, col0 + n) and rows [0, k)."""
    cols = slice(col0, col0 + n)
    q = np.asarray(qvals).view(np.int8)[:k, cols]
    s = planar_scales_f16(scales)[: k // QK, cols]
    return from_int8(np.ascontiguousarray(q.T), np.ascontiguousarray(s.T), device)


def quantize(w: torch.Tensor, kind: str) -> PackedWeight:
    """An f32 [n, k] weight -> PackedWeight of `kind` on w's device, computed
    there. Its planes are those of the GGUF blocks quant/blocks.py's numpy
    codecs write for the same values, bit for bit: the same f32 operations in
    the same order, each division tensor by tensor (torch on CUDA divides by
    a Python scalar as a multiply by its reciprocal), rounding half to even,
    the first index of a tied absmax."""
    if kind not in KINDS:
        raise ValueError(f"quantize: kind {kind!r} not in {KINDS}")
    n, k = w.shape
    if k % QK:
        raise ValueError(f"K={k} not divisible by {QK}")
    b = w.to(torch.float32).contiguous().reshape(n, k // QK, QK)
    one = torch.ones((), dtype=torch.float32, device=w.device)
    if kind == "q8_0":
        amax = b.abs().amax(dim=-1)
        d = (amax / (127 * one)).to(torch.float16)
        df = d.to(torch.float32)
        live = df > 0
        inv = torch.where(live, one / torch.where(live, df, one), 0.0)
        q = torch.round(b * inv[..., None]).clamp(-128, 127).to(torch.int8)
        return PackedWeight(n, k, q.reshape(n, k).contiguous(), d.contiguous(), "q8_0")
    idx = b.abs().argmax(dim=-1, keepdim=True)
    maxv = b.gather(-1, idx)[..., 0]
    d = (maxv / (-8 * one)).to(torch.float16)
    df = d.to(torch.float32)
    live = df != 0
    inv = torch.where(live, one / torch.where(live, df, one), 0.0)
    q = (b * inv[..., None] + 8.5).to(torch.int32).clamp(0, 15).to(torch.uint8)
    qs = q[..., :16] | (q[..., 16:] << 4)
    return PackedWeight(n, k, qs.reshape(n, k // 2).contiguous(), d.contiguous())


def concat(parts: list[PackedWeight]) -> PackedWeight:
    """Fuse same-kind, same-K weights along the out-feature axis (one launch
    for Q/K/V or gate/up); outputs keep the order of `parts`."""
    k, kind = parts[0].k, parts[0].kind
    if any(p.k != k for p in parts):
        raise ValueError("concat: mismatched K")
    if any(p.kind != kind for p in parts):
        raise ValueError(f"concat: mixed kinds {[p.kind for p in parts]}")
    return PackedWeight(sum(p.n for p in parts), k, torch.cat([p.qs for p in parts]),
                        torch.cat([p.d for p in parts]), kind)
