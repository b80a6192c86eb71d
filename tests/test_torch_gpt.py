"""The port's GPT-2 (zgml_tpu_torch/models/gpt.py, io/hf_loaders.load_gpt2_hf)
against the JAX package's, on the CPU.

Mirrors tests/test_io_extra.py's three GPT-2 cases on the port (engine
determinism, prefill against steps, the HF round trip), then holds the port
to the JAX model built from the same numpy params (init_params from one
seed, carried by io/llama_loader.gpt_params_from_jax) at d 64, 4 heads, 2
layers: ``forward`` logits of a prefill and of decode steps, with learned and
sinusoidal positions, at ZGML_TPU_PREFILL_BF16 unset (the default: K3's bf16
form, q and p rounded to bf16) and 0 (set around both packages), within
1e-5 * max|logit|: both sides compute in f32 over the same bf16 cache, their
sums in another order (measured: at most 4.6e-7); and the greedy tokens of
``LlamaEngine(GPTModel)`` against the JAX engine's (which samples at
temperature 0: JAX's GPT has no greedy head) exactly. The JAX side runs its
Pallas kernels in interpret mode (tests/conftest.py), the port its plain
versions (CPU tensors).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zgml_tpu.models import gpt as jgpt
from zgml_tpu.runtime.engine import LlamaEngine as JaxEngine

from zgml_tpu_torch.io.hf_loaders import load_gpt2_hf
from zgml_tpu_torch.io.llama_loader import gpt_params_from_jax
from zgml_tpu_torch.io.safetensors import save_safetensors
from zgml_tpu_torch.models.gpt import GPTConfig, GPTModel, init_params, sinusoidal_positions
from zgml_tpu_torch.runtime.engine import LlamaEngine
from zgml_tpu_torch.runtime.profile import global_profile

torch.set_num_threads(1)

CFG = GPTConfig(vocab_size=128, d_model=32, n_heads=4, n_layers=2, max_seq_len=32)
PARITY = dict(vocab_size=96, d_model=64, n_heads=4, n_layers=2, max_seq_len=64)
RTOL = 1e-5
FLAGS = {"default": None, "prefill_f32": "0"}


def _jax_cfg(cfg):
    return jgpt.GPTConfig(**dataclasses.asdict(cfg))


def _model(cfg, seed):
    return GPTModel(cfg, init_params(cfg, seed=seed, device="cpu"))


def test_gpt2_forward_and_engine():
    eng = LlamaEngine(_model(CFG, 0))
    out = eng.generate([1, 2, 3], 6)
    assert len(out) == 6
    eng.reset()
    assert eng.generate([1, 2, 3], 6) == out


def test_gpt2_prefill_matches_steps():
    model = _model(CFG, 1)
    toks = [5, 9, 2, 7, 11]
    cache = model.init_cache(1)
    for i, t in enumerate(toks):
        logits = model(torch.tensor([[t]]), cache, i)
    logits2 = model(torch.tensor([toks]), model.init_cache(1), 0)
    torch.testing.assert_close(logits2[:, -1], logits[:, -1], rtol=2e-2, atol=2e-2)


def _hf_tensors(p):
    """HF GPT-2 names for a params tree (Conv1D weights are [in, out])."""
    out = {"wte.weight": p["wte"], "wpe.weight": p["wpe"], "ln_f.weight": p["ln_f"]["g"],
           "ln_f.bias": p["ln_f"]["b"]}
    names = {"w_qkv": "attn.c_attn.weight", "b_qkv": "attn.c_attn.bias",
             "wo": "attn.c_proj.weight", "bo": "attn.c_proj.bias", "w_fc": "mlp.c_fc.weight",
             "b_fc": "mlp.c_fc.bias", "w_proj": "mlp.c_proj.weight", "b_proj": "mlp.c_proj.bias"}
    for i, lyr in enumerate(p["layers"]):
        for ln in ("ln_1", "ln_2"):
            out[f"h.{i}.{ln}.weight"], out[f"h.{i}.{ln}.bias"] = lyr[ln]["g"], lyr[ln]["b"]
        out.update({f"h.{i}.{hf}": lyr[key] for key, hf in names.items()})
    return {k: np.ascontiguousarray(np.asarray(v, np.float32)) for k, v in out.items()}


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_gpt2_hf_loader_roundtrip(tmp_path, dtype):
    """An HF-named file written from the JAX package's params: the port's
    load_gpt2_hf gives JAX's weights (f32 bit for bit; F16 as the file holds
    them), and its forward the logits of the port's model from the same
    params (the F16 file: of those params rounded to f16)."""
    jp = jax.tree_util.tree_map(np.asarray, jgpt.init_params(_jax_cfg(CFG), seed=2))
    tensors = {k: v.astype(dtype) for k, v in _hf_tensors(jp).items()}
    path = tmp_path / "gpt2.safetensors"
    save_safetensors(path, tensors)
    loaded = load_gpt2_hf(str(path), CFG, device="cpu")
    want = {k: v.astype(np.float32) for k, v in tensors.items()}
    got = _hf_tensors(loaded.params)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    direct = GPTModel(CFG, gpt_params_from_jax(jax.tree_util.tree_map(
        lambda a: np.asarray(a, dtype).astype(np.float32), jp), CFG, device="cpu"))
    toks = torch.tensor([[3, 1, 4]])
    torch.testing.assert_close(loaded(toks, loaded.init_cache(1), 0),
                               direct(toks, direct.init_cache(1), 0), rtol=0, atol=0)


def test_sinusoidal_positions_and_init_params_match_jax():
    np.testing.assert_array_equal(sinusoidal_positions(50, 24), jgpt.sinusoidal_positions(50, 24))
    for learned in (True, False):
        cfg = GPTConfig(**{**PARITY, "learned_pos": learned})
        jp = jax.tree_util.tree_map(np.asarray, jgpt.init_params(_jax_cfg(cfg), seed=4))
        tp = init_params(cfg, seed=4, device="cpu")
        assert ("wpe" in tp) == learned
        flat_j, _ = jax.tree_util.tree_flatten(jp)
        flat_t = jax.tree_util.tree_flatten(jax.tree_util.tree_map(
            lambda t: t.numpy(), tp, is_leaf=lambda t: isinstance(t, torch.Tensor)))[0]
        assert len(flat_j) == len(flat_t)
        for a, b in zip(flat_j, flat_t):
            np.testing.assert_array_equal(a, b)


def _pair(learned, seed=3, scale=0.02):
    cfg = GPTConfig(**{**PARITY, "learned_pos": learned})
    jm = jgpt.GPTModel(_jax_cfg(cfg), jgpt.init_params(_jax_cfg(cfg), seed=seed, scale=scale))
    npp = jax.tree_util.tree_map(np.asarray, jm.params)
    return jm, GPTModel(cfg, gpt_params_from_jax(npp, cfg, device="cpu"))


def _set_flag(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("ZGML_TPU_PREFILL_BF16", raising=False)
    else:
        monkeypatch.setenv("ZGML_TPU_PREFILL_BF16", value)


def _close(got, want):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= RTOL * float(np.abs(want).max()), err / float(np.abs(want).max())


@pytest.mark.parametrize("flag", FLAGS, ids=list(FLAGS))
@pytest.mark.parametrize("learned", [True, False], ids=["learned_pos", "sinusoidal"])
def test_forward_logits_match_jax(monkeypatch, learned, flag):
    """Prefill of 11 tokens from pos 0 (K3's plain version), then three
    decode steps (K4's) over the cache each side wrote."""
    _set_flag(monkeypatch, FLAGS[flag])
    jm, tm = _pair(learned)
    toks = np.random.default_rng(0).integers(0, PARITY["vocab_size"], (1, 11))
    jl, jc = jm.forward(jm.params, jnp.asarray(toks, jnp.int32), jm.init_cache(1), 0)
    tc = tm.init_cache(1)
    global_profile.reset()
    tl = tm(torch.from_numpy(toks), tc, 0)
    _close(tl, jl)
    for i in range(3):
        nxt = np.array([[int(np.argmax(np.asarray(jl)[0, -1]))]])
        jl, jc = jm.forward(jm.params, jnp.asarray(nxt, jnp.int32), jc, 11 + i)
        tl = tm(torch.from_numpy(nxt), tc, 11 + i)
        _close(tl, jl)
    tiers = global_profile.tier_summary()
    flash = "attention" if flag == "prefill_f32" else "attention_bf16"
    assert tiers[flash] == {"ref": 2} and tiers["decode_attention"] == {"ref": 6}


@pytest.mark.parametrize("learned", [True, False], ids=["learned_pos", "sinusoidal"])
def test_engine_greedy_tokens_match_jax(learned):
    """LlamaEngine(GPTModel): a 40-token prompt in chunks of 16 (the last
    padded), then 12 greedy tokens through decode_n (greedy_head), against
    the JAX engine's temperature-0 tokens. Weights at std 0.5: at the JAX
    init's 0.02 the tied head repeats one token throughout."""
    jm, tm = _pair(learned, seed=5, scale=0.5)
    prompt = np.random.default_rng(1).integers(0, PARITY["vocab_size"], 40)
    want = JaxEngine(jm, prefill_chunk=16, donate_cache=False).generate(prompt, 12)
    assert LlamaEngine(tm, prefill_chunk=16).generate(prompt, 12) == want


def test_f32_cache_is_refused():
    """The f32 cache is no longer refused (K3 has its f32-K/V forms): it is
    the bf16 cache's shape in f32. A dtype the JAX GPT engine makes no cache
    of (int8) still is."""
    model = _model(CFG, 0)
    cache = model.init_cache(1, "f32")
    assert cache["k"].dtype == cache["v"].dtype == torch.float32
    assert cache["k"].shape == model.init_cache(1)["k"].shape
    with pytest.raises(ValueError, match="cache dtype"):
        model.init_cache(1, "int8")
