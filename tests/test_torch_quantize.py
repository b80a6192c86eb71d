"""Post-hoc quantization (io/llama_loader.quantize_llama_params,
LlamaModel.quantize) against the JAX package's, on the CPU (mirrors
tests/test_model.py:187-215).

  - blocks: both packages quantize the same dense model, at Q8_0 and Q4_0,
    from fused weights (a dense-loaded F32 GGUF: wqkv and w_gate_up
    concatenated) and from unfused ones (an HF file loaded with fuse=False);
    the JAX result carried across by params_from_jax (the two packages lay
    packed weights out differently) equals the port's qs and scales bit for
    bit, key for key, and on the card's path packed.quantize gives the numpy
    codecs' bytes (tested here on CPU tensors, which run the same torch ops);
  - logits: the quantized models' prefill logits within 1e-3 * max|logit|
    and decode steps, each from the JAX cache of that step, within 1e-5 *
    max|logit| (the same int8 activations; f32 sums in another order), the
    JAX side in interpret mode under ZGML_TPU_SCALES=f16 and the prefill's
    f32 operands;
  - the reference's own check: a quantized Q8_0 copy tracks the dense model
    (cosine of the prefill logits > 0.99), and quantize returns the model.
"""
import dataclasses

import numpy as np
import pytest
import torch

from zgml_tpu.io.hf_loaders import load_llama_hf as jax_load_llama_hf
from zgml_tpu.io.llama_loader import load_llama as jax_load_llama
from zgml_tpu.io.llama_loader import quantize_llama_params as jax_quantize_llama_params
from zgml_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from zgml_tpu.models.llama import init_params as jax_init_params
from zgml_tpu.runtime.engine import LlamaEngine as JaxEngine

from zgml_tpu_torch.io.gguf import GGMLType
from zgml_tpu_torch.io.hf_loaders import load_llama_hf
from zgml_tpu_torch.io.llama_loader import load_llama, params_from_jax, quantize_llama_params
from zgml_tpu_torch.io.safetensors import save_safetensors
from zgml_tpu_torch.models.llama import LlamaConfig, LlamaModel
from zgml_tpu_torch.quant import blocks, packed
from zgml_tpu_torch.quant.packed import PackedWeight
from zgml_tpu_torch.runtime.engine import LlamaEngine
from zgml_tpu_torch.utils.synthetic import TINY_TEST, write_synthetic_llama_gguf

torch.set_num_threads(1)

FLAGS = {"ZGML_TPU_SCALES": "f16", "ZGML_TPU_PREFILL_BF16": "0"}
KINDS = ("q8_0", "q4_0")
HF_CFG = dict(vocab_size=96, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, n_layers=2,
              max_seq_len=32)
HF_NAMES = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj", "wv": "self_attn.v_proj",
            "wo": "self_attn.o_proj", "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
            "w_down": "mlp.down_proj"}
PROMPT_LEN, CHUNK, N_STEPS = 12, 16, 4


def _np_params(params):
    def conv(v):
        if hasattr(v, "qvals"):
            return dataclasses.replace(v, qvals=np.asarray(v.qvals), scales=np.asarray(v.scales))
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        return np.asarray(v)
    return conv(params)


@pytest.fixture(scope="module")
def f32_gguf(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("quantize") / "f32.gguf")
    write_synthetic_llama_gguf(path, TINY_TEST, GGMLType.F32, seed=21)
    return path


@pytest.fixture(scope="module")
def hf_file(tmp_path_factory):
    stacked = jax_init_params(JaxLlamaConfig(**HF_CFG), seed=4)
    tensors = {"model.embed_tokens.weight": np.asarray(stacked["tok_embd"]),
               "model.norm.weight": np.asarray(stacked["out_norm"]),
               "lm_head.weight": np.ascontiguousarray(np.asarray(stacked["lm_head"]).T)}
    for i in range(HF_CFG["n_layers"]):
        p = f"model.layers.{i}."
        tensors[p + "input_layernorm.weight"] = np.asarray(stacked["layers"]["attn_norm"][i])
        tensors[p + "post_attention_layernorm.weight"] = np.asarray(
            stacked["layers"]["ffn_norm"][i])
        for key, hf in HF_NAMES.items():
            tensors[f"{p}{hf}.weight"] = np.ascontiguousarray(
                np.asarray(stacked["layers"][key][i]).T)
    path = str(tmp_path_factory.mktemp("quantize_hf") / "llama.safetensors")
    save_safetensors(path, tensors)
    return path


def _dense_pair(source, path, monkeypatch):
    """(JAX dense model, port dense model on the CPU) of one file."""
    for k, v in FLAGS.items():
        monkeypatch.setenv(k, v)
    if source == "gguf":
        jmodel, jgf = jax_load_llama(path, mode="dense")
        jgf.close()
        model, gf = load_llama(path, device="cpu", mode="dense")
        gf.close()
        return jmodel, model
    return (jax_load_llama_hf(path, JaxLlamaConfig(**HF_CFG), fuse=False),
            load_llama_hf(path, LlamaConfig(**HF_CFG), fuse=False, device="cpu"))


def _assert_packed_equal(got, want):
    """The same kind, shape and bits, and got's planes contiguous (the
    kernels' wrappers refuse strided planes)."""
    assert isinstance(got, PackedWeight) and isinstance(want, PackedWeight)
    assert (got.kind, got.n, got.k) == (want.kind, want.n, want.k)
    assert got.qs.is_contiguous() and got.d.is_contiguous()
    assert torch.equal(got.qs, want.qs)
    assert torch.equal(got.d.view(torch.int16), want.d.view(torch.int16))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("source", ["gguf", "hf"])
def test_quantize_blocks_bit_equal_to_jax(f32_gguf, hf_file, monkeypatch, source, kind):
    jmodel, model = _dense_pair(source, f32_gguf if source == "gguf" else hf_file, monkeypatch)
    cfg = model.cfg
    jq = params_from_jax(_np_params(jax_quantize_llama_params(jmodel.params, kind)), cfg,
                         device="cpu")
    pq = quantize_llama_params(model.params, kind)
    fused = source == "gguf"
    for lj, lp in zip(jq["layers"], pq["layers"]):
        assert set(lj) == set(lp)
        assert ("wqkv" in lp and "w_gate_up" in lp) == fused
        for key, v in lp.items():
            if key.startswith("w"):
                _assert_packed_equal(v, lj[key])
            else:
                assert torch.equal(v, lj[key])
    _assert_packed_equal(pq["lm_head"], jq["lm_head"])
    assert pq["tok_embd"] is model.params["tok_embd"]
    # the dense model's own leaves are untouched
    assert not any(isinstance(v, PackedWeight) for ly in model.params["layers"]
                   for v in ly.values())


@pytest.mark.parametrize("kind", KINDS)
def test_packed_quantize_equals_the_numpy_codec(kind):
    """packed.quantize (the device quantizer) against quant/blocks.py, with
    blocks that are all zero, a negative absmax, ties of |max| and values
    that round to a half."""
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((48, 256)) * 0.05).astype(np.float32)
    w[0, :32] = 0.0
    w[1, 40] = -1.0
    w[2, 64:67] = [0.5, -0.5, 0.5]
    w[3, 96:128] = np.linspace(-1, 1, 32, dtype=np.float32)
    codec = {"q8_0": (blocks.quantize_q8_0, packed.from_gguf_q8_0),
             "q4_0": (blocks.quantize_q4_0, packed.from_gguf_q4_0)}[kind]
    want = codec[1](codec[0](w), *w.shape, device="cpu")
    _assert_packed_equal(packed.quantize(torch.from_numpy(w), kind), want)
    # a K-major [K, N] leaf's transpose, as quantize_llama_params hands it over
    _assert_packed_equal(packed.quantize(torch.from_numpy(np.ascontiguousarray(w.T)).t(), kind),
                         want)


def _runs(jmodel, model):
    """Prefill logits, and decode-step logits each from the JAX cache of that
    step, of both packages on the same prompt and fed tokens."""
    prompt = np.random.default_rng(5).integers(0, model.cfg.vocab_size, PROMPT_LEN)
    jeng, peng = JaxEngine(jmodel, prefill_chunk=CHUNK), LlamaEngine(model, prefill_chunk=CHUNK)
    jpre = np.asarray(jeng.prefill(prompt))[0]
    ppre = peng.prefill(prompt)[0].numpy()
    feed, jsteps, psteps = [int(np.argmax(jpre))], [], []
    for _ in range(N_STEPS):
        for k in ("k", "v"):
            peng.cache[k].copy_(torch.from_numpy(np.array(jeng.cache[k].astype(np.float32))))
        nxt, lg = jeng.step(np.array(feed[-1:], np.int32))
        jsteps.append(np.asarray(lg)[0])
        psteps.append(peng.step(torch.tensor(feed[-1:]))[1][0].numpy())
        feed.append(int(np.asarray(nxt)[0]))
    return (jpre, jsteps), (ppre, psteps)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("source", ["gguf", "hf"])
def test_quantized_model_logits_match_jax(f32_gguf, hf_file, monkeypatch, source, kind):
    jmodel, model = _dense_pair(source, f32_gguf if source == "gguf" else hf_file, monkeypatch)
    assert model.quantize(kind) is model
    jmodel.quantize(kind)
    (jpre, jsteps), (ppre, psteps) = _runs(jmodel, model)
    errs = [np.max(np.abs(ppre - jpre)) / np.max(np.abs(jpre))]
    assert errs[0] <= 1e-3
    for got, want in zip(psteps, jsteps):
        errs.append(np.max(np.abs(got - want)) / np.max(np.abs(want)))
        assert np.all(np.isfinite(got)) and errs[-1] <= 1e-5
    print(f"{source} {kind}: prefill {errs[0]:.3g}, steps up to {max(errs[1:]):.3g} of max|logit|")


def test_post_hoc_quantize_tracks_dense(f32_gguf):
    """The JAX package's own check (tests/test_model.py:187-215) on the port."""
    dense, gf = load_llama(f32_gguf, device="cpu", mode="dense")
    gf.close()
    toks = [3, 1, 4, 1, 5]
    ld = LlamaEngine(dense).prefill(toks)[0].numpy()
    qmodel = LlamaModel(dense.cfg, dense.params).quantize("q8_0")
    assert any(isinstance(v, PackedWeight) for v in qmodel.params["layers"][0].values())
    assert not any(isinstance(v, PackedWeight) for v in dense.params["layers"][0].values())
    lq = LlamaEngine(qmodel).prefill(toks)[0].numpy()
    cos = float(ld @ lq / (np.linalg.norm(ld) * np.linalg.norm(lq) + 1e-9))
    assert cos > 0.99, cos
