"""Guards of the port: no JAX, no fallback off the supported devices, a clear
build error without nvcc, wrappers that refuse what their kernel does not take."""
import pathlib
import subprocess
import sys

import pytest
import torch

from zgml_tpu_torch.ops import build, dispatch
from zgml_tpu_torch.ops.attention import decode_attention_cuda, flash_attention_cuda
from zgml_tpu_torch.ops.ffn import fused_ffn_norm_cuda
from zgml_tpu_torch.ops.layerkernel import attn_block_cuda
from zgml_tpu_torch.ops.qmatmul import (q4_greedy_cuda, q4_matmul_cuda, q4_matmul_i8_cuda,
                                        quantize_act_cuda)
from zgml_tpu_torch.quant.packed import PackedWeight

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
import zgml_tpu_torch
names = [m.name for m in pkgutil.walk_packages(zgml_tpu_torch.__path__, "zgml_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "zgml_tpu.")) or m == "zgml_tpu")
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env={"PYTHONPATH": str(REPO),
                                                       "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 20


def _pw(device):
    return PackedWeight(8, 32, torch.zeros(8, 16, dtype=torch.uint8, device=device),
                        torch.zeros(8, 1, dtype=torch.float16, device=device))


def test_dispatch_refuses_meta_device():
    x = torch.zeros(2, 32, device="meta")
    with pytest.raises(NotImplementedError, match="meta"):
        dispatch.qmatmul(x, _pw("meta"))
    q = torch.zeros(1, 2, 4, 16, device="meta")
    kv = torch.zeros(1, 1, 8, 16, device="meta", dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        dispatch.flash_attention(q, kv, kv, kv_len=4)
    with pytest.raises(NotImplementedError):
        dispatch.decode_attention(q[:, :, :1], kv, kv, 4)
    with pytest.raises(NotImplementedError):
        dispatch.rmsnorm(x, torch.ones(32, device="meta"))


def test_dispatch_refuses_mixed_devices():
    with pytest.raises(ValueError):
        dispatch.qmatmul(torch.zeros(2, 32), _pw("meta"))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("ZGML_TPU_TORCH_BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.build()
    assert not (tmp_path / "build").exists()


def test_build_names_library_by_source_hash(monkeypatch, tmp_path):
    monkeypatch.setenv("ZGML_TPU_TORCH_BUILD_DIR", str(tmp_path))
    p = build.library_path()
    assert p.parent == tmp_path and p.name.startswith("libzgml_kernels_")
    assert all((build.CSRC / s).is_file() for s in build.SOURCES + build.HEADERS)


def test_kernel_wrappers_refuse_cpu_tensors():
    """A launcher never runs the plain version: off the card it raises."""
    with pytest.raises(ValueError, match="CUDA"):
        q4_matmul_cuda(torch.zeros(1, 32), _pw("cpu"))
    q = torch.zeros(1, 2, 4, 16)
    kv = torch.zeros(1, 1, 8, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, kv, kv, 4)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_cuda(q[:, :, :1], kv, kv, 4)


def test_decode_tier_wrappers_refuse_cpu_tensors():
    """K1, K5, K6d and K7 launchers raise off the card, as K2-K4's do."""
    x = torch.zeros(1, 32)
    with pytest.raises(ValueError, match="CUDA"):
        q4_matmul_i8_cuda(x, _pw("cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        q4_greedy_cuda(x, _pw("cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        quantize_act_cuda(x)
    gu = PackedWeight(64, 32, torch.zeros(64, 16, dtype=torch.uint8),
                      torch.zeros(64, 1, dtype=torch.float16))
    wd = PackedWeight(32, 32, torch.zeros(32, 16, dtype=torch.uint8),
                      torch.zeros(32, 1, dtype=torch.float16))
    with pytest.raises(ValueError, match="CUDA"):
        fused_ffn_norm_cuda(x, torch.ones(32), gu, wd, 1e-5)
    cache = torch.zeros(1, 1, 1, 8, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        attn_block_cuda(x.reshape(1, 1, 32), torch.ones(32), _pw_n(96), _pw_n(32), cache,
                        cache, 0, torch.zeros(1, dtype=torch.int32), torch.ones(1, 16),
                        torch.zeros(1, 16), 1, 1, 1e-5)


def _pw_n(n):
    return PackedWeight(n, 32, torch.zeros(n, 16, dtype=torch.uint8),
                        torch.zeros(n, 1, dtype=torch.float16))


def test_force_ref_is_scoped():
    assert not dispatch._force_ref.get()
    with dispatch.force_ref():
        assert dispatch._force_ref.get()
    assert not dispatch._force_ref.get()
