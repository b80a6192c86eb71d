"""Port configuration: where the CUDA kernels are built, and which path runs.

The tier of an op follows the device of its tensors: a CUDA tensor runs the
kernel, a CPU tensor the plain torch version (ops/dispatch.py), and
``dispatch.force_ref()`` is the one explicit way to run the plain versions on
the card. The *path* follows thirteen of the JAX package's own variables, with
its defaults, read at call time (the port is eager), and a fourteenth turns
off the host codecs' native library as it does the JAX package's:

  ZGML_TPU_TORCH_BUILD_DIR=path   build_dir()          kernel build output
                                                       (default: <checkout>/build/zgml_tpu_torch)
  ZGML_TPU_ATTN_BLOCK=0           attn_block()         batch-1 decode without the layer
                                                       kernel K7 (default 1: on)
  ZGML_TPU_I8DOT=0                i8dot()              no int8-activation tier K1/K5:
                                                       f32-dequant K2 at every M (default 1)
  ZGML_TPU_KERNELS=ref            kernels_ref()        every op switched off (default
                                                       "pallas": on), as kernel_on() says
  ZGML_TPU_KERNELS_DISABLE=a,b    kernel_on(op)        the named ops switched off
  ZGML_TPU_KERNELS_FORCE=a,b      kernels_forced()     opt-in kernels of ops that run plain
                                                       torch by default; the port reads
                                                       "rmsnorm" (K12)
  ZGML_TPU_ATTN_I8A=0|1           attn_i8a(dp)         K7's int8 A phase (default: on where
                                                       the padded width dp >= 4096)
  ZGML_TPU_FFN_I8A=0|1            ffn_i8a(dp)          K6c, the Q4_0 decode FFN with int8
                                                       gate|up (default: on where dp >= 4096)
  ZGML_TPU_ATTN_I8PV=1            attn_i8pv()          K8's int8 P.V mode (default off): p
                                                       quantized per JAX key block
  ZGML_TPU_LAYER_FFN=1            layer_ffn()          the FFN as K7's phase E (default off):
                                                       the port runs its function, K6d's
  ZGML_TPU_STACK_DECODE=1         stack_decode()       batch-1 decode through K14, one launch
                                                       per token for the whole stack, where
                                                       LlamaModel.enable_stacked_decode()
                                                       attached its view (default off)
  ZGML_TPU_TAPE_DECODE=1          tape_decode()        the same through K15, where
                                                       enable_tape_decode() attached its view;
                                                       taken before K14 (default off)
  ZGML_TPU_TAPE_BF16=0            tape_bf16()          K15 with f32 operands (default 1:
                                                       bf16-rounded operands and weights)
  ZGML_TPU_PREFILL_BF16=0         prefill_bf16()       f32 prefill operands (default 1: K2 in
                                                       JAX's bf16 row tiles, K3 / K9 / K10
                                                       round their dot operands to bf16)
  ZGML_TPU_NATIVE=0               native()             the numpy GGUF block codecs, not the
                                                       g++-built host library (native/;
                                                       default 1: the library where it builds)

The two i8a flags take the JAX package's padded width of the weight, which
the port computes from its unpadded one (padded_k).

The per-op switches (ZGML_TPU_KERNELS=ref, ZGML_TPU_KERNELS_DISABLE) are the
environment's part of the JAX package's ``use_pallas(op)``
(zgml_tpu/ops/dispatch.py:41-52): ``kernel_on(op)`` is false under
ZGML_TPU_KERNELS=ref, or where ZGML_TPU_KERNELS_DISABLE names op; with no
name (the graph tier's fused chain) only ZGML_TPU_KERNELS=ref turns it off.
A switched-off op takes the JAX package's path for it, in the model and in
ops/dispatch.py:

  qmatmul           no int8-activation tier: the f32 dequant matmul (K2's
                    function) at every M, and no greedy head K5 (argmax of
                    the logits); K6 and K7 keep their own names
  attention         prefill (K3) and K9 run their plain versions, K9 over
                    the cache dequantized to f32 (JAX's dequantize-then-
                    attend); training's flash attention is the plain
                    attention under autograd, not K10
  decode_attention  K4 runs its plain version; over the int8 cache, the
                    cache dequantized to f32 and attended with the
                    unquantized q (JAX's function, not K8's)
  attn_block        batch-1 decode without K7, as ZGML_TPU_ATTN_BLOCK=0
  fused_ffn         no K6: the FFN composed from its projections
  rmsnorm           no K12, whatever ZGML_TPU_KERNELS_FORCE says
  stack_decode, tape_decode   no K14 / K15: the per-layer path
  ring_attention    ring attention's plain tier (parallel/ring.py: the online
                    softmax over the visiting K/V blocks) in place of one
                    K10f launch a ring hop, as JAX's einsum oracle

Where a switch swaps a kernel for its plain version of the same function, the
call counts under `ref`, as on the CPU. ``dispatch.use_kernel(op)`` is the
predicate that runs a kernel: kernel_on(op) and not under force_ref().
force_ref() keeps the path (it compares the kernels with their plain
versions on it); the switches change it. The port reads no other JAX flag.

ZGML_TPU_PREFILL_BF16 (zgml_tpu/config.py:188-191) picks the prefill's
numerics as it does the JAX package's, and with its default, 1: a K2 call
whose JAX row tile is at least 32 rows and that the int8 tier does not
take (ops/qmatmul.bf16_rows) rounds x and the dequantized weight
bf16(level * scale) to bf16 before an f32-accumulated dot
(qmatmul.py:57-63, :113-121); the flash kernels K3, K9, K10f, K10dq and
K10dkv round their dot operands to bf16 (attention.py:77-104, 625-644,
flash_vjp.py:60-84, 168-187, 258-284). "0" keeps every prefill operand
f32. Where qmatmul or attention is switched off, the JAX ref tier runs, in
f32 at every flag, and so does the port. Its weight scales stay the GGUF
file's fp16 values, which is ZGML_TPU_SCALES=f16.
"""
from __future__ import annotations

import contextlib
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


def native() -> bool:
    """The host codecs' native library may load (zgml_tpu/config.py:198-199)."""
    return _flag("ZGML_TPU_NATIVE", "1")


def attn_block() -> bool:
    """Batch-1 decode through the layer kernel K7 (zgml_tpu/config.py:99-100)."""
    return _flag("ZGML_TPU_ATTN_BLOCK", "1")


def i8dot() -> bool:
    """The int8-activation tier K1 (M <= 32) and the greedy head K5
    (zgml_tpu/config.py:184-185)."""
    return _flag("ZGML_TPU_I8DOT", "1")


@functools.lru_cache(maxsize=64)       # the dispatch reads the lists at every call
def _parse_names(raw: str) -> frozenset[str]:
    return frozenset(s.strip() for s in raw.split(",") if s.strip())


def _names(name: str) -> frozenset[str]:
    return _parse_names(os.environ.get(name, ""))


def kernels_ref() -> bool:
    """ZGML_TPU_KERNELS=ref (zgml_tpu/config.py:60-62): every op off."""
    return os.environ.get("ZGML_TPU_KERNELS", "pallas") == "ref"


def kernel_on(op: str | None = None) -> bool:
    """The environment's part of the JAX package's use_pallas(op): off under
    ZGML_TPU_KERNELS=ref, or for an op ZGML_TPU_KERNELS_DISABLE (comma-
    separated, zgml_tpu/config.py:65-66) names."""
    if kernels_ref():
        return False
    return op is None or op not in _names("ZGML_TPU_KERNELS_DISABLE")


def kernels_forced() -> frozenset[str]:
    """ZGML_TPU_KERNELS_FORCE, comma-separated (zgml_tpu/config.py:69-70):
    "rmsnorm" routes ops.dispatch.rmsnorm to K12 on the card."""
    return _names("ZGML_TPU_KERNELS_FORCE")


@contextlib.contextmanager
def force_kernels(names: str):
    """Set ZGML_TPU_KERNELS_FORCE to `names` inside the block and restore it
    after (zgml_tpu/config.py:73-90)."""
    saved = os.environ.get("ZGML_TPU_KERNELS_FORCE")
    os.environ["ZGML_TPU_KERNELS_FORCE"] = names
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("ZGML_TPU_KERNELS_FORCE", None)
        else:
            os.environ["ZGML_TPU_KERNELS_FORCE"] = saved


def attn_i8a(dp: int) -> bool:
    """K7's int8 A phase at padded width dp (zgml_tpu/config.py:133-137)."""
    return _flag("ZGML_TPU_ATTN_I8A", "1" if dp >= I8A_MIN_DP else "0") and dp % 32 == 0


def ffn_i8a(dp: int) -> bool:
    """The int8 gate|up phase of the Q4_0 decode FFN, K6c, at padded width dp
    (zgml_tpu/config.py:140-145)."""
    return _flag("ZGML_TPU_FFN_I8A", "1" if dp >= I8A_MIN_DP else "0") and dp % 32 == 0


def layer_ffn() -> bool:
    """ZGML_TPU_LAYER_FFN (zgml_tpu/config.py:103-105, only "1" is on): the
    JAX package then runs a Q4_0 decode FFN inside K7 as its phase E, the f32
    N-packed FFN, whatever ZGML_TPU_FFN_I8A says (layerkernel.py:762-765).
    The port runs that function as K6d after K7 (models/llama._ffn)."""
    return os.environ.get("ZGML_TPU_LAYER_FFN", "0") == "1"


def stack_decode() -> bool:
    """The all-layers decode megacall K14 (zgml_tpu/config.py:125-130)."""
    return _flag("ZGML_TPU_STACK_DECODE", "0")


def tape_decode() -> bool:
    """The tape-streamed whole-stack decode megacall K15
    (zgml_tpu/config.py:108-116)."""
    return _flag("ZGML_TPU_TAPE_DECODE", "0")


def tape_bf16() -> bool:
    """K15's bf16 operands (zgml_tpu/config.py:119-122); "0" makes every
    operand f32."""
    return _flag("ZGML_TPU_TAPE_BF16", "1")


def attn_i8pv() -> bool:
    """K8's int8 P.V mode (zgml_tpu/config.py:177-181; attention.py:440-448):
    p * v_scale quantized to int8 per JAX key block, an integer P.V. Read per
    call; only "1" turns it on, as in the JAX package."""
    return os.environ.get("ZGML_TPU_ATTN_I8PV", "0") == "1"


def prefill_bf16() -> bool:
    """bf16 dot operands on the prefill path: K2's bf16 row tiles and the
    flash kernels' score / P.V dots (zgml_tpu/config.py:188-191)."""
    return _flag("ZGML_TPU_PREFILL_BF16", "1")


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
