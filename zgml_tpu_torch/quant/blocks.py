"""ggml Q4_0 / Q8_0 block codecs in numpy, bit-exact with the GGUF layouts.

Counterpart of zgml_tpu/quant/blocks.py (same algorithms, so both packages
write identical bytes for the same input):

  Q4_0: 32 elements / 18-byte block = [f16 scale d][16 bytes of nibbles].
        Byte j holds element j (low nibble) and element j+16 (high nibble);
        value = (nibble - 8) * d, with d = (signed absmax) / -8.
  Q8_0: 32 elements / 34-byte block = [f16 scale d][32 int8], value = q * d,
        d = absmax / 127.

The four codecs run through the native host library (native/, C++ with
OpenMP, bit-equal) where it loads, as JAX's quantizers do (its
blocks.py:45-50, 76-80), so a GGUF load (io/gguf.py) dequantizes there too,
and through numpy otherwise (ZGML_TPU_NATIVE=0, or no g++).
"""
from __future__ import annotations

import numpy as np

from zgml_tpu_torch import native

QK = 32  # elements per block, both formats
Q4_0_BLOCK_BYTES = 18
Q8_0_BLOCK_BYTES = 34


def _as_u8(raw) -> np.ndarray:
    if isinstance(raw, np.ndarray):
        return raw.reshape(-1).view(np.uint8)
    return np.frombuffer(bytes(raw), dtype=np.uint8)


def _as_blocks(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32)
    if x.size % QK != 0:
        raise ValueError(f"element count {x.size} not divisible by block size {QK}")
    return x.reshape(-1, QK)


def quantize_q8_0(x: np.ndarray) -> np.ndarray:
    """f32 array -> raw Q8_0 bytes (uint8 [n_blocks * 34])."""
    b = _as_blocks(x)
    if native.available():
        return native.quantize(b, "q8_0")
    amax = np.max(np.abs(b), axis=1)
    d = (amax / 127.0).astype(np.float16)
    df = d.astype(np.float32)
    inv = np.where(df > 0, 1.0 / np.where(df > 0, df, 1.0), 0.0)
    q = np.clip(np.round(b * inv[:, None]), -128, 127).astype(np.int8)
    out = np.empty((b.shape[0], Q8_0_BLOCK_BYTES), dtype=np.uint8)
    out[:, :2] = d.view(np.uint8).reshape(-1, 2)
    out[:, 2:] = q.view(np.uint8)
    return out.reshape(-1)


def dequantize_q8_0(raw, n_elems: int) -> np.ndarray:
    """Raw Q8_0 bytes -> f32 [n_elems]."""
    n_blocks = -(-n_elems // QK)
    raw = _as_u8(raw)[: n_blocks * Q8_0_BLOCK_BYTES]
    if native.available():
        return native.dequant(raw, n_blocks, "q8_0")[:n_elems]
    blk = raw.reshape(n_blocks, Q8_0_BLOCK_BYTES)
    d = blk[:, :2].copy().view(np.float16).astype(np.float32).reshape(-1)
    q = blk[:, 2:].copy().view(np.int8).astype(np.float32)
    return (q * d[:, None]).reshape(-1)[:n_elems]


def quantize_q4_0(x: np.ndarray) -> np.ndarray:
    """f32 array -> raw Q4_0 bytes (uint8 [n_blocks * 18], ggml nibble order)."""
    b = _as_blocks(x)
    if native.available():
        return native.quantize(b, "q4_0")
    idx = np.argmax(np.abs(b), axis=1)
    maxv = b[np.arange(b.shape[0]), idx]
    d = (maxv / -8.0).astype(np.float16)
    df = d.astype(np.float32)
    inv = np.where(df != 0, 1.0 / np.where(df != 0, df, 1.0), 0.0)
    q = b * inv[:, None] + 8.5           # ggml rounds via floor(x * inv + 8.5)
    q = np.clip(q.astype(np.int32), 0, 15).astype(np.uint8)
    out = np.empty((b.shape[0], Q4_0_BLOCK_BYTES), dtype=np.uint8)
    out[:, :2] = d.view(np.uint8).reshape(-1, 2)
    out[:, 2:] = q[:, :16] | (q[:, 16:] << 4)
    return out.reshape(-1)


def dequantize_q4_0(raw, n_elems: int) -> np.ndarray:
    """Raw Q4_0 bytes -> f32 [n_elems]."""
    n_blocks = -(-n_elems // QK)
    raw = _as_u8(raw)[: n_blocks * Q4_0_BLOCK_BYTES]
    if native.available():
        return native.dequant(raw, n_blocks, "q4_0")[:n_elems]
    blk = raw.reshape(n_blocks, Q4_0_BLOCK_BYTES)
    d = blk[:, :2].copy().view(np.float16).astype(np.float32).reshape(-1)
    nib = blk[:, 2:]
    vals = np.empty((n_blocks, QK), dtype=np.float32)
    vals[:, :16] = (nib & 0x0F).astype(np.int8) - 8
    vals[:, 16:] = (nib >> 4).astype(np.int8) - 8
    return (vals * d[:, None]).reshape(-1)[:n_elems]


def f16_bytes_to_f32(raw, n_elems: int) -> np.ndarray:
    return _as_u8(raw)[: n_elems * 2].copy().view(np.float16).astype(np.float32)
