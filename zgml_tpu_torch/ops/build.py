"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The sources in zgml_tpu_torch/csrc/ compile into one shared library with a
plain C interface (no PyTorch headers, so a build takes seconds). Each
source compiles in its own nvcc process, all started together, then one
nvcc links the objects:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c csrc/<name>.cu -o <name>.o   (each)
    nvcc -shared *.o -o <build_dir>/libzgml_kernels_<hash>.so

No fast-math flag: the int8 tier's activation quantization (K1, K5 and the
i8a modes of K6 and K7) must round and divide as IEEE f32 does, like the JAX
package.

The library is built at first use into config.build_dir() (under build/,
which .gitignore lists), named by a hash of the sources and flags so an
edited source rebuilds, and reused by later processes. nvcc's output, which
includes ptxas' register and shared-memory report per kernel, is kept in
build.log beside it. A missing nvcc or a failed build raises
KernelBuildError: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

from zgml_tpu_torch import config

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("status.cu", "qmatmul.cu", "flash_attn.cu", "decode_attn.cu",
           "qmatmul_i8.cu", "ffn.cu", "ffn_planar.cu", "layer_attn.cu")
HEADERS = ("common.cuh", "decode_split.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# exported function -> argtypes (every launcher returns an int status; the
# weight launchers take the kind code of ops/qmatmul.py KIND_CODE first)
_SIGNATURES = {
    "zgml_qmatmul": (_I, _P, _P, _P, _P, _I, _I, _I, _P),
    "zgml_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    "zgml_decode_attention": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
    "zgml_decode_split_count": (_I,),
    "zgml_i8_quantize": (_P, _P, _P, _I, _I, _P),
    "zgml_qmatmul_i8": (_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "zgml_greedy": (_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
    "zgml_ffn_norm": (_I, _I, *(_P,) * 11, _I, _I, _I, _F, _P),
    "zgml_ffn": (_I, *(_P,) * 8, _I, _I, _I, _P),
    "zgml_attn_block": (_I, _I, *(_P,) * 19, _I, _I, _I, _I, _I, _F, _F, _P),
}


class KernelBuildError(RuntimeError):
    """nvcc is missing, or the kernel build failed."""


def find_nvcc() -> str:
    """nvcc on PATH, else $CUDA_HOME/bin/nvcc (CUDA_HOME defaults to
    /usr/local/cuda)."""
    cands = [shutil.which("nvcc"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin, CUDA_HOME defaulting "
        "to /usr/local/cuda): the CUDA kernels of zgml_tpu_torch cannot be built. "
        "CPU tensors run the plain torch versions and need no build.")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> pathlib.Path:
    return config.build_dir() / f"libzgml_kernels_{_digest()}.so"


def build() -> tuple[pathlib.Path, float]:
    """Compile the library unless it exists; returns (path, seconds spent
    compiling, 0.0 when it was already built)."""
    out = library_path()
    if out.exists():
        return out, 0.0
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    work = out.parent / f"{out.stem}.{os.getpid()}.objs"
    work.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    jobs = []
    for src in SOURCES:
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(work / f"{src}.o")]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, proc in jobs:
        text, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + text)
        if proc.returncode != 0:
            failed.append(f"{cmd[-3]} (exit {proc.returncode}):\n{text[-3000:]}")
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(work / f"{s}.o") for s in SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link (exit {proc.returncode}):\n{proc.stderr[-3000:]}")
    seconds = time.perf_counter() - t0
    (out.parent / "build.log").write_text("\n".join(log))
    shutil.rmtree(work, ignore_errors=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, out)     # atomic: a concurrent process sees all or nothing
    return out, seconds


_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.zgml_error_string.argtypes = (ctypes.c_int,)
            lib.zgml_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(status: int, what: str):
    """Raise if a launcher returned a non-zero status."""
    if status != 0:
        msg = library().zgml_error_string(status).decode()
        raise RuntimeError(f"{what}: kernel launch failed with status {status}: {msg}")
