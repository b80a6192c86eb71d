"""The port's safetensors codec (zgml_tpu_torch/io/safetensors.py) and HF llama
loader (io/hf_loaders.load_llama_hf) against the JAX package's, on the CPU
(mirrors tests/test_io_extra.py:10-44 and :107-140).

  - the codec: a round trip, the bytes either package writes for the same
    tensors and metadata equal, each reads the other's file, BF16 widened by
    the bit shift (exact for the values a bf16 holds);
  - the loader: an HF-named file written from the JAX package's init_params
    (f32, and the same file in F16 as HF checkpoints ship), loaded by both
    packages fused and unfused; the port's weights equal JAX's bit for bit,
    and its prefill logits and two greedy decode steps equal JAX's within
    1e-4 * max|logit| (dense f32 on both sides over the same bf16 cache
    rounding: f32 sums in another order). Both run under ZGML_TPU_SCALES=f16
    and the prefill's f32 operands (ZGML_TPU_PREFILL_BF16=0); the JAX side
    in its ref tier.
"""
import json
import struct

import numpy as np
import pytest
import torch

from zgml_tpu.io.hf_loaders import load_llama_hf as jax_load_llama_hf
from zgml_tpu.io.safetensors import SafetensorsFile as JaxSafetensorsFile
from zgml_tpu.io.safetensors import save_safetensors as jax_save_safetensors
from zgml_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from zgml_tpu.models.llama import init_params as jax_init_params
from zgml_tpu.ops.dispatch import force_ref as jax_force_ref
from zgml_tpu.runtime.engine import LlamaEngine as JaxEngine

from zgml_tpu_torch.io.hf_loaders import load_llama_hf
from zgml_tpu_torch.io.safetensors import SafetensorsFile, save_safetensors
from zgml_tpu_torch.models.llama import LlamaConfig
from zgml_tpu_torch.runtime.engine import LlamaEngine

torch.set_num_threads(1)

FLAGS = {"ZGML_TPU_SCALES": "f16", "ZGML_TPU_PREFILL_BF16": "0"}
RTOL = 1e-4
CFGS = {"tied": dict(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2, d_ff=48, n_layers=2,
                     max_seq_len=16, tied_lm_head=True),
        "head": dict(vocab_size=96, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, n_layers=2,
                     max_seq_len=32)}
HF_NAMES = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj", "wv": "self_attn.v_proj",
            "wo": "self_attn.o_proj", "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
            "w_down": "mlp.down_proj"}


def _tensors():
    rng = np.random.default_rng(0)
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": (rng.standard_normal(8) * 10).astype(np.float16),
            "c": np.arange(6, dtype=np.int32).reshape(2, 3),
            "d": rng.integers(-100, 100, (5,)).astype(np.int8)}


def test_safetensors_roundtrip(tmp_path):
    tensors = _tensors()
    p = tmp_path / "t.safetensors"
    save_safetensors(p, tensors, {"origin": "test"})
    with SafetensorsFile(p) as st:
        assert st.metadata["origin"] == "test"
        assert set(st.keys()) == set(tensors)
        for k in tensors:
            np.testing.assert_array_equal(st.tensor(k), tensors[k])


def test_safetensors_bytes_and_files_match_jax(tmp_path):
    tensors = _tensors()
    mine, theirs = tmp_path / "port.safetensors", tmp_path / "jax.safetensors"
    save_safetensors(mine, tensors, {"origin": "test"})
    jax_save_safetensors(theirs, tensors, {"origin": "test"})
    assert mine.read_bytes() == theirs.read_bytes()
    with SafetensorsFile(theirs) as st, JaxSafetensorsFile(mine) as jst:
        for k in tensors:
            np.testing.assert_array_equal(st.tensor(k), jst.tensor(k))


def test_safetensors_bf16(tmp_path):
    vals = np.asarray([1.0, -2.5, 0.15625, 3.0e38], np.float32)
    u16 = (vals.view(np.uint32) >> 16).astype(np.uint16)
    header = {"x": {"dtype": "BF16", "shape": [4], "data_offsets": [0, 8]}}
    hjson = json.dumps(header).encode()
    with open(tmp_path / "b.safetensors", "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        f.write(u16.tobytes())
    with SafetensorsFile(tmp_path / "b.safetensors") as st, \
            JaxSafetensorsFile(tmp_path / "b.safetensors") as jst:
        out = st.tensor("x")
        assert out.dtype == np.float32
        np.testing.assert_array_equal(out, jst.tensor("x"))
        np.testing.assert_array_equal(out.view(np.uint32), u16.astype(np.uint32) << 16)


def _write_hf(path, cfg, seed, dtype):
    """HF names, [out, in] weights, from the JAX init_params of `seed`."""
    stacked = jax_init_params(JaxLlamaConfig(**cfg), seed=seed)
    cast = (lambda a: np.asarray(a, np.float32).astype(dtype))
    tensors = {"model.embed_tokens.weight": cast(stacked["tok_embd"]),
               "model.norm.weight": cast(stacked["out_norm"])}
    for i in range(cfg["n_layers"]):
        p = f"model.layers.{i}."
        tensors[p + "input_layernorm.weight"] = cast(stacked["layers"]["attn_norm"][i])
        tensors[p + "post_attention_layernorm.weight"] = cast(stacked["layers"]["ffn_norm"][i])
        for key, hf in HF_NAMES.items():
            tensors[f"{p}{hf}.weight"] = np.ascontiguousarray(
                cast(stacked["layers"][key][i]).T)
    if not cfg.get("tied_lm_head"):
        tensors["lm_head.weight"] = np.ascontiguousarray(cast(stacked["lm_head"]).T)
    jax_save_safetensors(path, tensors)


def _run(eng, prompt, steps, step_tokens):
    """The prefill's last logits and the logits of decode steps fed
    `step_tokens` (so both packages see the same inputs)."""
    out = [np.asarray(eng.prefill(prompt))[0]]
    for t in step_tokens[:steps]:
        out.append(np.asarray(eng.step(np.array([t], np.int32) if isinstance(eng, JaxEngine)
                                       else torch.tensor([t]))[1])[0])
    return out


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_load_llama_hf_matches_jax(tmp_path, monkeypatch, name, dtype, fuse):
    cfg = CFGS[name]
    path = str(tmp_path / "llama.safetensors")
    _write_hf(path, cfg, seed=3, dtype=dtype)
    for k, v in FLAGS.items():
        monkeypatch.setenv(k, v)
    jmodel = jax_load_llama_hf(path, JaxLlamaConfig(**cfg), fuse=fuse)
    model = load_llama_hf(path, LlamaConfig(**cfg), fuse=fuse, device="cpu")
    assert model.device == torch.device("cpu")
    for lj, lp in zip(jmodel.params["layers"], model.params["layers"]):
        assert set(lj) == set(lp)
        for key in lj:
            assert torch.equal(lp[key], torch.from_numpy(np.array(lj[key]))), key
    for key in ("tok_embd", "out_norm", "lm_head"):
        if key in jmodel.params:
            assert torch.equal(model.params[key],
                               torch.from_numpy(np.array(jmodel.params[key]))), key
    prompt = np.random.default_rng(1).integers(0, cfg["vocab_size"], 7)
    steps = [5, 9]
    with jax_force_ref():
        want = _run(JaxEngine(jmodel, prefill_chunk=8), prompt, 2, steps)
    got = _run(LlamaEngine(model, prefill_chunk=8), prompt, 2, steps)
    errs = [np.max(np.abs(g - w)) / np.max(np.abs(w)) for g, w in zip(got, want)]
    print(f"{name} {np.dtype(dtype).name} fuse={fuse}: logits up to {max(errs):.3g} of max|logit|")
    assert all(np.all(np.isfinite(g)) for g in got) and max(errs) <= RTOL


def test_load_llama_hf_defaults_to_the_card(tmp_path):
    """Without device= the model goes to the card, so a machine with none
    raises rather than hand back a CPU model."""
    path = str(tmp_path / "llama.safetensors")
    _write_hf(path, CFGS["tied"], seed=3, dtype=np.float32)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default loads onto it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_llama_hf(path, LlamaConfig(**CFGS["tied"]))
