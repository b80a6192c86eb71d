"""The native host library: the GGUF Q4_0 / Q8_0 block codecs in C++ (host.cpp),
built lazily with g++ and loaded with ctypes.

Counterpart of zgml_tpu/native/__init__.py, with its four codecs
(quantize_q8_0, quantize_q4_0, dequant_q8_0, dequant_q4_0) and not its
planar repacks, which build the TPU layout the port does not keep. A host
codec, not a device path: its bytes are those of quant/blocks.py's numpy
codecs bit for bit (tests/test_torch_native.py), and where the library cannot
be built or loaded the numpy codecs run, as in the JAX package.

The library is built at first use into config.build_dir() (never into the
package; nothing built is committed), named by a hash of the source, the
command and the host CPU (-march=native code for one CPU may not run on
another that shares the build directory), with

    g++ -O3 -march=native -ffp-contract=off -fopenmp -shared -fPIC host.cpp

(-ffp-contract=off keeps `x * inv + 8.5f` two roundings, as numpy's, where
-march=native would let GCC fuse it into an FMA). ZGML_TPU_NATIVE=0
(config.native) leaves it unloaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import platform
import shutil
import subprocess
import threading

import numpy as np

from zgml_tpu_torch import config

SRC = pathlib.Path(__file__).resolve().parent / "host.cpp"
FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-fopenmp", "-shared", "-fPIC")
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def host_cpu() -> bytes:
    """What -march=native compiles for: the CPU's model and feature flags
    (Linux's /proc/cpuinfo, first processor), else the platform's machine
    and processor names."""
    try:
        with open("/proc/cpuinfo", "rb") as fh:
            lines = fh.read().split(b"\n\n", 1)[0].splitlines()
        keys = (b"vendor_id", b"model name", b"flags", b"Features", b"CPU part")
        cpu = b"\n".join(ln for ln in lines if ln.split(b":", 1)[0].strip() in keys)
        if cpu:
            return cpu
    except OSError:
        pass
    return f"{platform.machine()} {platform.processor()}".encode()


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(FLAGS).encode() + SRC.read_bytes() + host_cpu()).hexdigest()[:16]
    return config.build_dir() / f"libzgml_host_{h}.so"


def _build(out: pathlib.Path) -> bool:
    gxx = shutil.which("g++")
    if gxx is None:
        return False
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([gxx, *FLAGS, str(SRC), "-o", str(tmp)], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)      # atomic: a concurrent process sees all or nothing
    return True


def get_lib() -> ctypes.CDLL | None:
    """The loaded library (built at first use), or None: ZGML_TPU_NATIVE=0,
    no g++, or a failed build or load. A failure is tried once a process."""
    global _lib, _tried
    if not config.native():
        return None
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        out = library_path()
        if not out.exists() and not _build(out):
            return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError:
            return None
        i64 = ctypes.c_int64
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
        for name, args in (("quantize_q8_0", (f32p, i64, u8p)), ("quantize_q4_0", (f32p, i64, u8p)),
                           ("dequant_q8_0", (u8p, i64, f32p)), ("dequant_q4_0", (u8p, i64, f32p))):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def quantize(x: np.ndarray, kind: str) -> np.ndarray:
    """f32 [n_blocks, 32] (contiguous) -> the raw GGUF bytes of `kind`
    (uint8 [n_blocks * 18] Q4_0, [n_blocks * 34] Q8_0) through the library,
    which must be loaded."""
    from zgml_tpu_torch.quant.blocks import Q4_0_BLOCK_BYTES, Q8_0_BLOCK_BYTES
    nb = x.shape[0]
    out = np.empty(nb * {"q4_0": Q4_0_BLOCK_BYTES, "q8_0": Q8_0_BLOCK_BYTES}[kind], np.uint8)
    getattr(get_lib(), f"quantize_{kind}")(np.ascontiguousarray(x.reshape(-1)), nb, out)
    return out


def dequant(raw: np.ndarray, n_blocks: int, kind: str) -> np.ndarray:
    """Raw GGUF bytes of n_blocks blocks of `kind` -> f32 [n_blocks * 32]
    through the library, which must be loaded."""
    from zgml_tpu_torch.quant.blocks import Q4_0_BLOCK_BYTES, Q8_0_BLOCK_BYTES
    raw = np.ascontiguousarray(raw, dtype=np.uint8).reshape(-1)
    need = n_blocks * {"q4_0": Q4_0_BLOCK_BYTES, "q8_0": Q8_0_BLOCK_BYTES}[kind]
    if raw.size < need:
        raise ValueError(f"{kind}: {raw.size} bytes hold fewer than {n_blocks} blocks")
    out = np.empty(n_blocks * 32, np.float32)
    getattr(get_lib(), f"dequant_{kind}")(raw, n_blocks, out)
    return out
