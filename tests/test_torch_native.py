"""The port's native host library (zgml_tpu_torch/native: the GGUF Q4_0 / Q8_0
block codecs in C++, built with g++ into config.build_dir()) against the
numpy codecs of zgml_tpu_torch/quant/blocks.py, on the CPU: bit for bit, on
blocks drawn from a seed across magnitudes, with all-zero blocks, a block
whose absmax sits at two places of opposite sign, subnormal and large
values. ZGML_TPU_NATIVE=0 leaves the library unloaded (and the numpy codecs
run); the library is built outside the package, under a name that follows
the host CPU, and refuses a buffer shorter than its blocks.
"""
import numpy as np
import pytest

from zgml_tpu_torch import config, native
from zgml_tpu_torch.quant import blocks

KINDS = ("q4_0", "q8_0")


def _blocks(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((512, 32)) * np.exp(rng.uniform(-12, 12, (512, 1)))).astype(
        np.float32)
    x[0] = 0.0                                  # s = 0: inverse 0
    x[1, 3], x[1, 9] = -2.5, 2.5                # a tied absmax: the first one's sign
    x[2] = np.float32(1e-41) * np.arange(32)    # subnormals
    x[3] = np.float32(3e4) * (rng.random(32) - 0.5)
    return x


@pytest.fixture
def lib():
    if not native.available():
        pytest.fail("the native host library did not build (g++ with -fopenmp is needed)")
    return native.get_lib()


def _numpy(monkeypatch, fn, *args):
    monkeypatch.setenv("ZGML_TPU_NATIVE", "0")
    try:
        return fn(*args)
    finally:
        monkeypatch.delenv("ZGML_TPU_NATIVE")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", KINDS)
def test_native_codecs_are_bit_equal_to_numpy(lib, monkeypatch, kind, seed):
    x = _blocks(seed)
    quantize = getattr(blocks, f"quantize_{kind}")
    with np.errstate(all="ignore"):
        ref = _numpy(monkeypatch, quantize, x)
        nat = native.quantize(x, kind)
        assert nat.dtype == np.uint8 and np.array_equal(nat, ref)
        assert np.array_equal(quantize(x), ref)           # blocks.py through the library
        dequantize = getattr(blocks, f"dequantize_{kind}")
        want = _numpy(monkeypatch, dequantize, ref, x.size)
        got = native.dequant(ref, x.shape[0], kind)
        through = dequantize(ref.tobytes(), x.size)       # blocks.py through the library
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.array_equal(through.view(np.uint32), want.view(np.uint32))


def test_native_off_leaves_the_library_unloaded(monkeypatch):
    monkeypatch.setenv("ZGML_TPU_NATIVE", "0")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert not config.native()
    assert native.get_lib() is None and not native.available()
    assert native._lib is None and not native._tried


def test_native_library_builds_outside_the_package(lib):
    path = native.library_path()
    assert path.parent == config.build_dir() and path.is_file()
    assert native.SRC.parent not in path.parents
    assert "-ffp-contract=off" in native.FLAGS


def test_native_library_name_follows_the_host_cpu(monkeypatch):
    """-march=native code is the host CPU's: a build directory shared by two
    CPUs holds one library for each."""
    here = native.library_path()
    assert native.host_cpu()
    monkeypatch.setattr(native, "host_cpu", lambda: b"model name\t: another CPU")
    there = native.library_path()
    assert there != here and there.parent == here.parent


@pytest.mark.parametrize("kind", KINDS)
def test_native_dequant_refuses_a_short_buffer(lib, kind):
    raw = getattr(blocks, f"quantize_{kind}")(_blocks(0)[:4])
    with pytest.raises(ValueError, match="fewer than 5 blocks"):
        native.dequant(raw, 5, kind)
    with pytest.raises(ValueError):
        getattr(blocks, f"dequantize_{kind}")(raw, 5 * 32)
