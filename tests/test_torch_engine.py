"""The port's engine, sampling, plain ops and CLI on the CPU (plain torch tier),
with the plain ops held to the JAX package's references on the same inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zgml_tpu.ops import refs as jrefs

from zgml_tpu_torch.io.gguf import GGMLType, tensor_nbytes
from zgml_tpu_torch.io.llama_loader import load_llama
from zgml_tpu_torch.ops import refs
from zgml_tpu_torch.quant.packed import PackedWeight
from zgml_tpu_torch.runtime.engine import LlamaEngine
from zgml_tpu_torch.runtime.sampling import SamplingParams, sample
from zgml_tpu_torch.utils import cli
from zgml_tpu_torch.utils.synthetic import TINY_TEST, write_synthetic_llama_gguf

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_engine") / "tiny.gguf")
    write_synthetic_llama_gguf(path, TINY_TEST, seed=1)
    return path


@pytest.fixture(scope="module")
def model(tiny_path):
    m, gf = load_llama(tiny_path, device="cpu")
    gf.close()
    return m


def test_decode_n_matches_step_loop(model):
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5]
    e1 = LlamaEngine(model, prefill_chunk=4)
    tok = int(torch.argmax(e1.prefill(prompt)[0]))
    burst = e1.decode_n([tok], 6)[:, 0].tolist()
    e2 = LlamaEngine(model, prefill_chunk=4)
    e2.prefill(prompt)
    t, steps = torch.tensor([tok]), []
    for _ in range(6):
        t, _ = e2.step(t)
        steps.append(int(t[0]))
    assert burst == steps
    assert e1.pos == e2.pos == len(prompt) + 6


@pytest.fixture
def unfused_flags(monkeypatch):
    """The JAX flags of the port's first slice: f32-dequant projections at
    every M, f32 prefill operands (ZGML_TPU_PREFILL_BF16=0)."""
    for k, v in {"ZGML_TPU_ATTN_BLOCK": "0", "ZGML_TPU_KERNELS_DISABLE": "fused_ffn",
                 "ZGML_TPU_I8DOT": "0", "ZGML_TPU_PREFILL_BF16": "0"}.items():
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("chunk", [1, 5, 64])
def test_prefill_is_chunk_invariant(model, chunk, unfused_flags):
    """Under the f32-dequant tier the chunking changes only the order of f32
    sums. Under the default flags chunks of <= 32 rows take the int8 tier and
    larger ones the f32 tier, in the JAX package as here
    (tests/test_torch_llama.py::test_default_prefill_head_tier_matches_jax)."""
    prompt = np.arange(13) * 7 % TINY_TEST.vocab_size
    ref = LlamaEngine(model, prefill_chunk=13).prefill(prompt)
    got = LlamaEngine(model, prefill_chunk=chunk).prefill(prompt)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


def test_reset_reuses_the_cache(model):
    eng = LlamaEngine(model, prefill_chunk=8)
    a = eng.generate([5, 6, 7], 5)
    eng.reset()
    eng.prefill([100, 101, 102, 103, 104, 105])    # leaves stale entries past kv_len
    eng.reset()
    assert eng.generate([5, 6, 7], 5) == a


def test_generate_stops_and_bounds(model):
    eng = LlamaEngine(model, prefill_chunk=8)
    out = eng.generate([1, 2], 10, burst=4)
    assert len(out) == 10
    eng.reset()
    cut = eng.generate([1, 2], 10, stop_ids=(out[3],), burst=4)
    assert cut == out[:out.index(out[3]) + 1]
    eng.reset()
    with pytest.raises(ValueError, match="SequenceTooLong"):
        eng.prefill(np.zeros(TINY_TEST.max_seq_len + 1, np.int64))


def test_sampling_modes():
    logits = torch.tensor([[0.0, 5.0, 1.0, -2.0], [3.0, 0.0, 0.0, 2.9]])
    g = torch.Generator().manual_seed(0)
    assert sample(logits, SamplingParams(), g).tolist() == [1, 0]
    top1 = sample(logits, SamplingParams(temperature=1.0, top_k=1), g)
    assert top1.tolist() == [1, 0]
    draws = torch.stack([sample(logits, SamplingParams(temperature=1.0, top_p=0.5), g)
                         for _ in range(50)])
    assert set(draws[:, 0].tolist()) == {1}          # p(1) > 0.5 alone
    wide = torch.stack([sample(logits, SamplingParams(temperature=2.0), g)
                        for _ in range(200)])
    assert len(set(wide[:, 1].tolist())) > 1


def test_plain_ops_match_jax_refs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    g = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(refs.rmsnorm(torch.from_numpy(x), torch.from_numpy(g)).numpy(),
                               np.asarray(jrefs.rmsnorm_ref(jnp.asarray(x), jnp.asarray(g))),
                               rtol=1e-6, atol=1e-6)
    pos = np.arange(7, 12)
    cos, sin = refs.rope_cos_sin(torch.from_numpy(pos), 64, 10000.0)
    jcos, jsin = jrefs.rope_cos_sin(jnp.asarray(pos), 64, 10000.0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), rtol=1e-6, atol=1e-6)
    q = rng.standard_normal((1, 4, 5, 64)).astype(np.float32)
    np.testing.assert_allclose(
        refs.rope_apply(torch.from_numpy(q), cos, sin).numpy(),
        np.asarray(jrefs.rope_apply_ref(jnp.asarray(q), jcos, jsin)), rtol=1e-5, atol=1e-5)
    a, b = x[0], x[1]
    np.testing.assert_allclose(
        refs.swiglu(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jrefs.swiglu_ref(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6, atol=1e-6)


def test_cli_generate_on_cpu(tiny_path, capsys):
    cli.main(["report", tiny_path, "--device", "cpu", "--prompt-ids", "1,2,3", "-n", "4"])
    out = capsys.readouterr().out
    assert "output ids:" in out and "qmatmul" in out


def test_cli_generate_int8_cache_on_cpu(tiny_path, capsys):
    """--kv int8: the prefill through K9's plain version and, at TINY_TEST's
    head_dim 16 (no K7), batch-1 decode through K8's."""
    from zgml_tpu_torch.runtime.profile import global_profile
    global_profile.reset()
    cli.main(["report", tiny_path, "--device", "cpu", "--kv", "int8", "--prompt-ids", "1,2,3",
              "-n", "4"])
    out = capsys.readouterr().out
    assert "output ids:" in out and "flash_attention_q8" in out and "decode_attention_q8" in out
    assert " attention " not in out and "decode_attention " not in out


def test_load_llama_refuses_q8_0_weights(tmp_path, monkeypatch):
    """What the loader cannot run is refused, not dequantized in silence.
    Q8_0 loads (it has its kernels), and so do F16 matmul weights, dense, as
    the JAX package loads them (`_load_matmul`) since the dense load mode;
    a quantized layer whose q/k/v mix types (attn_v F16 beside Q4_0) loads
    unfused, as the JAX package's `_load_fused` loads it: wq and wk packed,
    wv dense. A type the JAX package cannot decode either (Q4_1) is refused,
    naming it."""
    from zgml_tpu_torch.utils import synthetic
    path = str(tmp_path / "tiny_f16.gguf")
    write_synthetic_llama_gguf(path, TINY_TEST, quant=GGMLType.F16)
    model, gf = load_llama(path, device="cpu")
    gf.close()
    layer = model.params["layers"][0]
    assert all(isinstance(layer[n], torch.Tensor) and layer[n].dtype == torch.float32
               for n in ("wqkv", "wo", "w_gate_up", "w_down"))

    def mixed_file(name, ggml_type):
        class MixedWriter(synthetic.GGUFWriter):
            def add_raw_tensor(self, tname, shape, t, raw):
                if "attn_v" in tname and t != ggml_type:
                    n = int(np.prod(shape))
                    raw, t = np.zeros(tensor_nbytes(ggml_type, n), np.uint8), ggml_type
                return super().add_raw_tensor(tname, shape, t, raw)
        with monkeypatch.context() as mp:
            mp.setattr(synthetic, "GGUFWriter", MixedWriter)
            out = str(tmp_path / name)
            synthetic.write_synthetic_llama_gguf(out, TINY_TEST, quant=GGMLType.Q4_0)
        return out

    model, gf = load_llama(mixed_file("tiny_mixed.gguf", GGMLType.F16), device="cpu")
    gf.close()
    for layer in model.params["layers"]:
        assert "wqkv" not in layer and isinstance(layer["w_gate_up"], PackedWeight)
        assert layer["wq"].kind == layer["wk"].kind == "q4_0"
        assert isinstance(layer["wv"], torch.Tensor) and layer["wv"].dtype == torch.float32
    with pytest.raises(NotImplementedError, match="Q4_1"):
        load_llama(mixed_file("tiny_q4_1.gguf", GGMLType.Q4_1), device="cpu")
