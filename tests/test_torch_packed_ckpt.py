"""The port's packed checkpoint (zgml_tpu_torch/io/packed_ckpt.py) on the CPU:
a llama loaded from a synthetic GGUF (d 512, 8/2 heads, 2 layers) in the
quantized mode at Q4_0 and at Q8_0 and in the dense mode, written with
save_packed_llama and read back with load_packed_llama.

  - the round trip gives the config and every tensor bit-equal to
    load_llama's (each PackedWeight's kind, n, k and its qs / d planes, the
    dense leaves), and the same logits bit for bit;
  - the megacall views are not written; the loaded model rebuilds them;
  - the port's logits from its packed file are within 1e-5 * max|logit| of
    the JAX package's from its own packed file of the same GGUF
    (load_packed_llama, ZGML_TPU_SCALES=f16), both over the f32 cache with
    f32 operands everywhere (ZGML_TPU_I8DOT=0, ZGML_TPU_PREFILL_BF16=0: the
    two differ only in the order of f32 sums);
  - a file the JAX package wrote (its TPU planar layout) and a safetensors
    file without the port's layout key are refused with a ValueError before
    any tensor is read.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zgml_tpu.io.llama_loader import load_llama as jax_load_llama
from zgml_tpu.io.packed_ckpt import load_packed_llama as jax_load_packed
from zgml_tpu.io.packed_ckpt import save_packed_llama as jax_save_packed
from zgml_tpu.runtime.engine import LlamaEngine as JaxEngine

from zgml_tpu_torch.io.gguf import GGMLType
from zgml_tpu_torch.io.llama_loader import load_llama
from zgml_tpu_torch.io.packed_ckpt import LAYOUT, load_packed_llama, save_packed_llama
from zgml_tpu_torch.io.safetensors import SafetensorsFile, save_safetensors
from zgml_tpu_torch.models.llama import LlamaConfig
from zgml_tpu_torch.quant.packed import PackedWeight
from zgml_tpu_torch.runtime.engine import LlamaEngine
from zgml_tpu_torch.utils.synthetic import write_synthetic_llama_gguf

torch.set_num_threads(1)

CFG = LlamaConfig(vocab_size=96, d_model=512, n_heads=8, n_kv_heads=2, d_ff=1024, n_layers=2,
                  max_seq_len=64)
F32_FLAGS = {"ZGML_TPU_SCALES": "f16", "ZGML_TPU_I8DOT": "0", "ZGML_TPU_PREFILL_BF16": "0"}
CASES = [(GGMLType.Q4_0, "quantized"), (GGMLType.Q8_0, "quantized"), (GGMLType.Q4_0, "dense")]


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("packed_ckpt")
    out = {}
    for quant in (GGMLType.Q4_0, GGMLType.Q8_0):
        out[quant] = str(tmp / f"d512_{quant.name}.gguf")
        write_synthetic_llama_gguf(out[quant], CFG, quant=quant, seed=13)
    return out


def _leaves(params, prefix=""):
    if isinstance(params, dict):
        for k, v in params.items():
            yield from _leaves(v, f"{prefix}.{k}")
    elif isinstance(params, list):
        for i, v in enumerate(params):
            yield from _leaves(v, f"{prefix}#{i}")
    else:
        yield prefix, params


def _prefill(model, prompt, cache="bf16"):
    return LlamaEngine(model, prefill_chunk=16, cache_dtype=cache).prefill(prompt)


@pytest.mark.parametrize("quant,mode", CASES, ids=["q4_0", "q8_0", "dense"])
def test_packed_round_trip_is_the_gguf_load(ggufs, tmp_path, quant, mode):
    model, gf = load_llama(ggufs[quant], device="cpu", mode=mode)
    gf.close()
    path = str(tmp_path / "m.safetensors")
    save_packed_llama(path, model)
    back = load_packed_llama(path, device="cpu")
    assert back.cfg == model.cfg
    want, got = dict(_leaves(model.params)), dict(_leaves(back.params))
    assert want.keys() == got.keys()
    for name, w in want.items():
        g = got[name]
        if isinstance(w, PackedWeight):
            assert isinstance(g, PackedWeight) and (g.kind, g.n, g.k) == (w.kind, w.n, w.k)
            assert torch.equal(g.qs, w.qs) and torch.equal(g.d, w.d), name
            assert g.qs.dtype == w.qs.dtype and g.d.dtype == torch.float16
        else:
            assert g.dtype == w.dtype and torch.equal(g, w), name
    assert (mode == "dense") == (not isinstance(back.params["layers"][0]["wqkv"], PackedWeight))
    prompt = np.random.default_rng(3).integers(0, CFG.vocab_size, 20)
    assert torch.equal(_prefill(back, prompt), _prefill(model, prompt))
    assert load_packed_llama(path, max_seq_len=32, device="cpu").cfg.max_seq_len == 32


def test_megacall_views_are_not_written(ggufs, tmp_path):
    model, gf = load_llama(ggufs[GGMLType.Q4_0], device="cpu")
    gf.close()
    assert model.enable_stacked_decode()
    path = str(tmp_path / "m.safetensors")
    save_packed_llama(path, model)
    with SafetensorsFile(path) as st:
        assert st.metadata["zgml_torch_layout"] == LAYOUT
        assert not any("layers_stacked" in k for k in st.keys())
    back = load_packed_llama(path, device="cpu")
    assert "layers_stacked" not in back.params
    assert back.enable_stacked_decode()
    view = back.params["layers_stacked"]
    assert int(view.table[1, 2]) == back.params["layers"][1]["wqkv"].qs.data_ptr()


@pytest.mark.parametrize("quant", [GGMLType.Q4_0, GGMLType.Q8_0], ids=["q4_0", "q8_0"])
def test_packed_logits_match_jax_packed(ggufs, tmp_path, monkeypatch, quant):
    for k, v in F32_FLAGS.items():
        monkeypatch.setenv(k, v)
    prompt = np.random.default_rng(4).integers(0, CFG.vocab_size, 20)
    jm, jgf = jax_load_llama(ggufs[quant])
    jgf.close()
    jpath = str(tmp_path / "jax.safetensors")
    jax_save_packed(jpath, jm)
    jm = jax_load_packed(jpath)
    want = np.asarray(JaxEngine(jm, prefill_chunk=16, cache_dtype=jnp.float32,
                                donate_cache=False).prefill(prompt))
    pm, pgf = load_llama(ggufs[quant], device="cpu")
    pgf.close()
    path = str(tmp_path / "port.safetensors")
    save_packed_llama(path, pm)
    got = _prefill(load_packed_llama(path, device="cpu"), prompt, "f32").numpy()
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))


def test_jax_written_file_is_refused(ggufs, tmp_path, monkeypatch):
    monkeypatch.setenv("ZGML_TPU_SCALES", "f16")
    jm, jgf = jax_load_llama(ggufs[GGMLType.Q4_0])
    jgf.close()
    path = str(tmp_path / "jax.safetensors")
    jax_save_packed(path, jm)
    with pytest.raises(ValueError, match="TPU planar layout"):
        load_packed_llama(path, device="cpu")


def test_foreign_safetensors_is_refused(tmp_path):
    path = str(tmp_path / "other.safetensors")
    save_safetensors(path, {"w": np.zeros((2, 2), np.float32)}, metadata={"format": "pt"})
    with pytest.raises(ValueError, match="not a packed checkpoint of the port"):
        load_packed_llama(path, device="cpu")
