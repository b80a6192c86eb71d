"""Port configuration: where the CUDA kernels are built, and which path runs.

The tier of an op follows the device of its tensors: a CUDA tensor runs the
kernel, a CPU tensor the plain torch version (ops/dispatch.py), and
``dispatch.force_ref()`` is the one explicit way to run the plain versions on
the card. The *path* follows five of the JAX package's own variables, with
its defaults, read at call time (the port is eager):

  ZGML_TPU_TORCH_BUILD_DIR=path   build_dir()          kernel build output
                                                       (default: <checkout>/build/zgml_tpu_torch)
  ZGML_TPU_ATTN_BLOCK=0           attn_block()         batch-1 decode without the layer
                                                       kernel K7 (default 1: on)
  ZGML_TPU_I8DOT=0                i8dot()              no int8-activation tier K1/K5:
                                                       f32-dequant K2 at every M (default 1)
  ZGML_TPU_KERNELS_DISABLE=a,b    kernels_disabled()   names of kernels turned off; the port
                                                       reads "fused_ffn" (K6) only
  ZGML_TPU_ATTN_I8A=0|1           attn_i8a(dp)         K7's int8 A phase (default: on where
                                                       the padded width dp >= 4096)
  ZGML_TPU_FFN_I8A=0|1            ffn_i8a(dp)          K6c, the Q4_0 decode FFN with int8
                                                       gate|up (default: on where dp >= 4096)

The two i8a flags take the JAX package's padded width of the weight, which
the port computes from its unpadded one (padded_k). The port reads no other
JAX flag. Its prefill operands stay f32, which is the JAX package's
ZGML_TPU_PREFILL_BF16=0, and its weight scales stay the GGUF file's fp16
values, which is ZGML_TPU_SCALES=f16.
"""
from __future__ import annotations

import functools
import os
import pathlib

_CHECKOUT = pathlib.Path(__file__).resolve().parent.parent
I8A_MIN_DP = 4096         # the i8a flags' default threshold (zgml_tpu/config.py:133-145)


def build_dir() -> pathlib.Path:
    """Directory that holds the built kernel library (listed in .gitignore)."""
    raw = os.environ.get("ZGML_TPU_TORCH_BUILD_DIR", "")
    return pathlib.Path(raw) if raw else _CHECKOUT / "build" / "zgml_tpu_torch"


def _flag(name: str, default: str) -> bool:
    # as zgml_tpu/config.py:49-50 reads it: only "0" turns a flag off
    return os.environ.get(name, default) != "0"


def attn_block() -> bool:
    """Batch-1 decode through the layer kernel K7 (zgml_tpu/config.py:99-100)."""
    return _flag("ZGML_TPU_ATTN_BLOCK", "1")


def i8dot() -> bool:
    """The int8-activation tier K1 (M <= 32) and the greedy head K5
    (zgml_tpu/config.py:184-185)."""
    return _flag("ZGML_TPU_I8DOT", "1")


def kernels_disabled() -> frozenset[str]:
    """ZGML_TPU_KERNELS_DISABLE, comma-separated (zgml_tpu/config.py:65-66)."""
    raw = os.environ.get("ZGML_TPU_KERNELS_DISABLE", "")
    return frozenset(s.strip() for s in raw.split(",") if s.strip())


def attn_i8a(dp: int) -> bool:
    """K7's int8 A phase at padded width dp (zgml_tpu/config.py:133-137)."""
    return _flag("ZGML_TPU_ATTN_I8A", "1" if dp >= I8A_MIN_DP else "0") and dp % 32 == 0


def ffn_i8a(dp: int) -> bool:
    """The int8 gate|up phase of the Q4_0 decode FFN, K6c, at padded width dp
    (zgml_tpu/config.py:140-145)."""
    return _flag("ZGML_TPU_FFN_I8A", "1" if dp >= I8A_MIN_DP else "0") and dp % 32 == 0


def tile_friendly_pad(x: int) -> int:
    """The JAX package's padded size of a weight dim
    (zgml_tpu/quant/repack.py _tile_friendly_pad)."""
    for align in (1024, 512, 256, 128):
        p = -(-x // align) * align
        if p - x <= max(align // 4, 0.08 * x):
            return p
    return -(-x // 128) * 128


@functools.lru_cache(maxsize=None)      # asked per decode launch; a pure function
def padded_k(k: int, kind: str) -> int:
    """The K the JAX loader pads a weight of `kind` to (repack.py:158-159,
    194-195): tile_friendly_pad(k) rounded up to 512 at Q4_0 (both K halves
    32-block aligned), to 32 at Q8_0. The port keeps k unpadded and asks this
    only to take the JAX package's path."""
    align = 512 if kind == "q4_0" else 32
    return -(-tile_friendly_pad(k) // align) * align
