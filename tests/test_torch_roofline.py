"""The port's decode roofline (zgml_tpu_torch/runtime/roofline.py) against
the JAX package's (zgml_tpu/runtime/roofline.py), on the CPU.

  - kv_bytes_per_token equals JAX's for the bf16, the int8 and the f32 cache;
  - weight_bytes_per_token of a model loaded from one synthetic GGUF (Q4_0,
    Q8_0, a tied head) equals JAX's once JAX's PackedWeight is counted at
    its unpadded (n, k) with fp16 scales, the port's planes (JAX's counts its
    TPU padding and its scale storage); the megacall views add nothing;
  - roofline() divides the given bandwidth by those bytes, and the bandwidth
    probe refuses a device that is no card.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zgml_tpu.io.llama_loader import load_llama as jax_load_llama
from zgml_tpu.quant.repack import PackedWeight as JaxPackedWeight
from zgml_tpu.runtime import roofline as jroof

from zgml_tpu_torch.io.gguf import GGMLType
from zgml_tpu_torch.io.llama_loader import load_llama
from zgml_tpu_torch.models.llama import LlamaConfig
from zgml_tpu_torch.runtime import roofline
from zgml_tpu_torch.utils.synthetic import write_synthetic_llama_gguf

CFG = LlamaConfig(vocab_size=96, d_model=512, n_heads=8, n_kv_heads=2, d_ff=1024, n_layers=2,
                  max_seq_len=64)


@pytest.mark.parametrize("cfg", [CFG, dataclasses.replace(CFG, n_layers=32, d_model=4096,
                                                          n_heads=32, n_kv_heads=32)])
@pytest.mark.parametrize("kv_len", [1, 160, 2048])
def test_kv_bytes_match_jax(cfg, kv_len):
    for port, jax_dtype in (("bf16", jnp.bfloat16), ("int8", "int8"), ("f32", jnp.float32)):
        assert roofline.kv_bytes_per_token(cfg, kv_len, port) == \
            jroof.kv_bytes_per_token(cfg, kv_len, jax_dtype)
    with pytest.raises(ValueError, match="cache dtype"):
        roofline.kv_bytes_per_token(cfg, kv_len, "f16")


def _unpadded(leaf) -> int:
    if isinstance(leaf, JaxPackedWeight):
        qs = leaf.n * leaf.k // (2 if leaf.kind == "q4_0" else 1)
        return qs + leaf.n * (leaf.k // 32) * 2
    return int(np.prod(leaf.shape)) * jnp.dtype(leaf.dtype).itemsize


@pytest.mark.parametrize("quant,tied", [(GGMLType.Q4_0, False), (GGMLType.Q8_0, False),
                                        (GGMLType.Q4_0, True)], ids=["q4_0", "q8_0", "tied"])
def test_weight_bytes_match_jax(tmp_path, monkeypatch, quant, tied):
    monkeypatch.setenv("ZGML_TPU_SCALES", "f16")
    cfg = dataclasses.replace(CFG, tied_lm_head=tied)
    path = str(tmp_path / "m.gguf")
    write_synthetic_llama_gguf(path, cfg, quant=quant, seed=5)
    jm, jgf = jax_load_llama(path)
    jgf.close()
    pm, pgf = load_llama(path, device="cpu")
    pgf.close()
    assert ("lm_head" in pm.params) == (not tied)
    monkeypatch.setattr(jroof, "_leaf_bytes", _unpadded)
    want = jroof.weight_bytes_per_token(jm.params)
    assert roofline.weight_bytes_per_token(pm.params) == want
    if quant == GGMLType.Q4_0 and not tied:
        assert pm.enable_stacked_decode() and pm.enable_tape_decode() is not None
        assert roofline.weight_bytes_per_token(pm.params) == want
    r = roofline.roofline(pm, 160, "f32", bandwidth=2.0e12)
    per_tok = want + roofline.kv_bytes_per_token(cfg, 160, "f32")
    assert r["bytes_per_token"] == per_tok and r["achievable_tok_s"] == 2.0e12 / per_tok


def test_bandwidth_probe_needs_a_card():
    with pytest.raises(ValueError, match="no card"):
        roofline.measure_hbm_bandwidth(1 << 20, 2, device="cpu")
