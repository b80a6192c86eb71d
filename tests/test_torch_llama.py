"""The port's whole slice against the JAX package on tiny Q4_0 and Q8_0 models.

Both packages load the same synthetic GGUF and run with the same JAX flags,
set (monkeypatch) around BOTH sides, since the port reads them too:

  - the port's first slice (SLICE_FLAGS): per-layer kernels over the stacked bf16
    cache, no fused FFN, f32-dequant GEMV, on TINY_TEST;
  - the default tier (DEFAULT_FLAGS: ATTN_BLOCK, I8DOT and the fused FFN on,
    as the JAX defaults; f16 scales and f32 prefill operands, which the port
    always has): batch-1 decode through the layer kernel K7, the fused FFN
    K6d and the greedy head K5, logits of M <= 32 calls through K1. It runs
    on the config of tests/test_layerkernel.py:266 (d 512, 8/2 heads, hd 64,
    d_ff 1024): TINY_TEST's head_dim 16 is not K7-compatible, and at d 256
    the JAX package's padding (w_down n_pad 256 vs w_gate_up k_pad 512)
    attaches no N-packed FFN view, so its decode FFN runs as two K1
    projections there instead of K6d (the port follows: ops/ffn.ffn_fuses).
    The prefill head's tier (int8 for a chunk of <= 32 rows) is checked on
    the d 256 config of tests/test_layerkernel.py:126, and the fused FFN of
    16-row prefill chunks (rmsnorm, K6b, residual on both sides) at d 512;
  - the default tier at Q8_0 on the same d 512 config: K7 in its Q8_0 mode,
    the fused FFN K6a (JAX attaches no N-packed view at Q8_0, so its fused
    decode runs `_ffn_kernel` through ffn_compatible), the greedy head K5q8,
    K1q8 for the step logits and K2q8 for the 64-row prefill chunk;
  - the 7B-width int8 tier (I8A_FLAGS: ZGML_TPU_ATTN_I8A=1 and
    ZGML_TPU_FFN_I8A=1, which the JAX package turns on by default at padded
    d >= 4096) forced on the same d 512 Q4_0 model: K7's int8 A phase and
    K6c per decode layer. Decode steps from a shared cache agree within
    1e-2 * max|logit| (the int8 rule below: each step runs 2 int8 pre-passes
    per layer, whose norms torch and XLA sum in another order), greedy
    tokens up to the first JAX top-2 gap under that bound, and each layer
    half on shared inputs within 1e-5 * max|out|, its int8 activations equal
    to JAX's bit for bit.

The JAX side runs its Pallas kernels in interpret mode; the port its plain
torch versions (CPU tensors). Bounds: logits within 1e-3 * max|logit| (both
sides f32 over the same bf16 cache rounding, or the same int8 activations;
only the order of f32 sums differs), and greedy decode_n(8) tokens identical
up to the first step where the JAX top-2 logit gap is below that bound (a
tie within rounding may break either way). Default-tier decode steps start
from the JAX cache of that step and agree within 1e-5 * max|logit| (see
default_runs for why the cache is shared).
"""
import dataclasses

import numpy as np
import pytest
import torch

from zgml_tpu.io.llama_loader import load_llama as jax_load_llama
from zgml_tpu.quant.repack import dequant_packed
from zgml_tpu.runtime.engine import LlamaEngine as JaxEngine

from zgml_tpu_torch.io.gguf import GGMLType
from zgml_tpu_torch.io.llama_loader import load_llama, params_from_jax
from zgml_tpu_torch.models.llama import LlamaConfig, LlamaModel
from zgml_tpu_torch.runtime.engine import LlamaEngine
from zgml_tpu_torch.runtime.profile import global_profile
from zgml_tpu_torch.utils.synthetic import TINY_TEST, write_synthetic_llama_gguf

DEFAULT_CFG = LlamaConfig(vocab_size=96, d_model=512, n_heads=8, n_kv_heads=2, d_ff=1024,
                          n_layers=2, max_seq_len=96)
PREFILL_CFG = LlamaConfig(vocab_size=96, d_model=256, n_heads=8, n_kv_heads=2, d_ff=192,
                          n_layers=2, max_seq_len=96)

torch.set_num_threads(1)

SLICE_FLAGS = {
    "ZGML_TPU_ATTN_BLOCK": "0",
    "ZGML_TPU_KERNELS_DISABLE": "fused_ffn",
    "ZGML_TPU_I8DOT": "0",
    "ZGML_TPU_SCALES": "f16",
    "ZGML_TPU_PREFILL_BF16": "0",
}
DEFAULT_FLAGS = {"ZGML_TPU_SCALES": "f16", "ZGML_TPU_PREFILL_BF16": "0"}
I8A_FLAGS = {**DEFAULT_FLAGS, "ZGML_TPU_ATTN_I8A": "1", "ZGML_TPU_FFN_I8A": "1"}
I8_RTOL = 1e-2             # whole-model int8-tier bound (PERF.md, the int8 tier's flips)
PROMPT_LEN, CHUNK, N_DECODE = 20, 16, 8


def _set_flags(mp, flags):
    for k in (*SLICE_FLAGS, *I8A_FLAGS, "ZGML_TPU_LAYER_FFN", "ZGML_TPU_KERNELS"):
        mp.delenv(k, raising=False)
    for k, v in flags.items():
        mp.setenv(k, v)


def _np_params(params):
    def conv(v):
        if hasattr(v, "qvals"):
            return dataclasses.replace(v, qvals=np.asarray(v.qvals),
                                       scales=np.asarray(v.scales))
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        return np.asarray(v)
    return conv(params)


def _port_run(model):
    eng = LlamaEngine(model, prefill_chunk=CHUNK)
    prompt = np.random.default_rng(5).integers(0, TINY_TEST.vocab_size, PROMPT_LEN)
    logits = eng.prefill(prompt)[0].numpy()
    tok0 = int(np.argmax(logits))
    toks = eng.decode_n([tok0], N_DECODE)[:, 0].tolist()
    return logits, tok0, toks


@pytest.fixture(scope="module")
def slice_runs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_llama") / "tiny_q4.gguf")
    write_synthetic_llama_gguf(path, TINY_TEST, seed=3)
    with pytest.MonkeyPatch.context() as mp:
        _set_flags(mp, SLICE_FLAGS)
        jmodel, jgf = jax_load_llama(path)
        prompt = np.random.default_rng(5).integers(0, TINY_TEST.vocab_size, PROMPT_LEN)
        jeng = JaxEngine(jmodel, prefill_chunk=CHUNK)
        jlogits = np.asarray(jeng.prefill(prompt))[0]
        tok0 = int(np.argmax(jlogits))
        jtoks = np.asarray(jeng.decode_n(np.array([tok0], np.int32), N_DECODE))[:, 0]
        # per-step logits of the same greedy run, for the top-2 gaps
        jeng.reset()
        jeng.prefill(prompt)
        tok, gaps = np.array([tok0], np.int32), []
        for _ in range(N_DECODE):
            nxt, lg = jeng.step(tok)
            top2 = np.sort(np.asarray(lg)[0])[-2:]
            gaps.append(float(top2[1] - top2[0]))
            tok = np.asarray(nxt)
        np_params = _np_params(jmodel.params)
        cfg = LlamaConfig(**dataclasses.asdict(jmodel.cfg))
        jgf.close()
        port_conv = _port_run(LlamaModel(cfg, params_from_jax(np_params, cfg, device="cpu")))
        pmodel, pgf = load_llama(path, device="cpu")
        pgf.close()
        port_loaded = _port_run(pmodel)
    return {"jax": (jlogits, tok0, jtoks.tolist(), gaps), "converted": port_conv,
            "loaded": port_loaded, "cfg": cfg, "pcfg": pmodel.cfg}


@pytest.mark.parametrize("route", ["converted", "loaded"])
def test_prefill_logits_match_jax(slice_runs, route):
    jlogits = slice_runs["jax"][0]
    logits = slice_runs[route][0]
    bound = 1e-3 * np.max(np.abs(jlogits))
    assert logits.shape == jlogits.shape == (TINY_TEST.vocab_size,)
    assert np.all(np.isfinite(logits))
    assert np.max(np.abs(logits - jlogits)) <= bound


@pytest.mark.parametrize("route", ["converted", "loaded"])
def test_greedy_tokens_match_jax(slice_runs, route):
    jlogits, tok0, jtoks, gaps = slice_runs["jax"]
    _, ptok0, ptoks = slice_runs[route]
    bound = 1e-3 * np.max(np.abs(jlogits))
    top2 = np.sort(jlogits)[-2:]
    # token i of decode_n comes from logits whose top-2 gap is gaps[i]; a gap
    # below the bound is a tie within rounding, so the comparison stops there
    if top2[1] - top2[0] < bound:
        print(f"prefill top-2 gap {top2[1] - top2[0]:.3g} < {bound:.3g}: no token compared")
        return
    assert ptok0 == tok0
    n_cmp = next((i for i, g in enumerate(gaps) if g < bound), N_DECODE)
    if n_cmp < N_DECODE:
        print(f"JAX top-2 gap {gaps[n_cmp]:.3g} < {bound:.3g} at step {n_cmp}: "
              f"comparing the first {n_cmp} of {N_DECODE} tokens")
    assert ptoks[:n_cmp] == jtoks[:n_cmp]


def test_loaded_config_matches_jax(slice_runs):
    assert slice_runs["pcfg"] == slice_runs["cfg"]


def test_cpu_run_uses_plain_tier_only(monkeypatch):
    """CPU tensors never reach the kernel tier (there is no card here); on
    the first slice every projection is K2's plain version."""
    _set_flags(monkeypatch, SLICE_FLAGS)
    global_profile.reset()
    cfg = dataclasses.replace(TINY_TEST, n_layers=1)
    rng = np.random.default_rng(0)
    from zgml_tpu_torch.quant.packed import from_nibbles

    def pw(n, k):
        return from_nibbles(rng.integers(1, 16, (n, k), dtype=np.uint8),
                            np.full((n, k // 32), 0.01, np.float16), "cpu")
    hd = cfg.head_dim
    layer = {"attn_norm": torch.ones(cfg.d_model), "ffn_norm": torch.ones(cfg.d_model),
             "wqkv": pw((cfg.n_heads + 2 * cfg.n_kv_heads) * hd, cfg.d_model),
             "wo": pw(cfg.d_model, cfg.n_heads * hd),
             "w_gate_up": pw(2 * cfg.d_ff, cfg.d_model), "w_down": pw(cfg.d_model, cfg.d_ff)}
    params = {"tok_embd": torch.from_numpy(rng.standard_normal((cfg.vocab_size, cfg.d_model),
                                                              dtype=np.float32)),
              "out_norm": torch.ones(cfg.d_model), "layers": [layer],
              "lm_head": pw(cfg.vocab_size, cfg.d_model)}
    out = LlamaEngine(LlamaModel(cfg, params), prefill_chunk=8).generate([1, 2, 3], 4)
    assert len(out) == 4
    tiers = global_profile.tier_summary()
    assert all(set(t) <= {"ref", "torch"} for t in tiers.values()), tiers
    assert tiers["qmatmul"]["ref"] > 0 and tiers["attention"]["ref"] == 1
    assert tiers["decode_attention"]["ref"] == 3


def _gap(logits) -> float:
    top2 = np.sort(logits)[-2:]
    return float(top2[1] - top2[0])


def _cache_np(jcache):
    return {k: np.array(jcache[k].astype(np.float32)) for k in ("k", "v")}


def _load_cache(eng, cache):
    for k in ("k", "v"):
        eng.cache[k].copy_(torch.from_numpy(cache[k]).to(torch.bfloat16))


@pytest.fixture(scope="module")
def default_runs(tmp_path_factory):
    """The default tier on DEFAULT_CFG, prefill chunk 64 (> 32 rows: f32
    projections, as the JAX engine's chunk plan), then greedy decode_n and a
    step() loop fed the same tokens on both sides. Decode starts from the JAX
    cache on both sides, and each step() of the port from the JAX cache of
    that step: the two prefills' f32 K/V round to
    bf16 differently at ~1% of the values (one ulp), and random weights turn
    that into ~3e-3 * max|logit| (PERF.md). With the cache shared, a
    step's inputs are identical and the bound can be tight."""
    return _default_runs(tmp_path_factory, GGMLType.Q4_0, seed=11)


@pytest.fixture(scope="module")
def q8_runs(tmp_path_factory):
    """default_runs at Q8_0 (same config, prompt and comparisons)."""
    return _default_runs(tmp_path_factory, GGMLType.Q8_0, seed=14)


@pytest.fixture(scope="module")
def i8a_runs(tmp_path_factory):
    """default_runs at Q4_0 with the int8 decode tier forced on (I8A_FLAGS)."""
    return _default_runs(tmp_path_factory, GGMLType.Q4_0, seed=11, flags=I8A_FLAGS)


@pytest.fixture(scope="module")
def layer_ffn_runs(tmp_path_factory):
    """i8a_runs with ZGML_TPU_LAYER_FFN=1: JAX runs each decode FFN as K7's
    phase E (f32), whatever ZGML_TPU_FFN_I8A says."""
    return _default_runs(tmp_path_factory, GGMLType.Q4_0, seed=11,
                         flags={**I8A_FLAGS, "ZGML_TPU_LAYER_FFN": "1"})


def _default_runs(tmp_path_factory, quant, seed, flags=DEFAULT_FLAGS):
    path = str(tmp_path_factory.mktemp("torch_default") / f"d512_{quant.name}.gguf")
    write_synthetic_llama_gguf(path, DEFAULT_CFG, quant=quant, seed=seed)
    prompt = np.random.default_rng(6).integers(0, DEFAULT_CFG.vocab_size, PROMPT_LEN)
    with pytest.MonkeyPatch.context() as mp:
        _set_flags(mp, flags)
        jmodel, jgf = jax_load_llama(path)
        jgf.close()
        # the JAX decode FFN is K6d (N-packed view) at Q4_0, K6a at Q8_0
        assert ("ffn_q4n" in jmodel.params["layers"][0]) == (quant == GGMLType.Q4_0)
        jeng = JaxEngine(jmodel, prefill_chunk=64)
        jlogits = np.asarray(jeng.prefill(prompt))[0]
        jcache0 = _cache_np(jeng.cache)
        tok0 = int(np.argmax(jlogits))
        jtoks = np.asarray(jeng.decode_n(np.array([tok0], np.int32), N_DECODE))[:, 0].tolist()
        jeng.reset()
        jeng.prefill(prompt)
        feed, jstep, jcaches = [tok0], [], []
        for _ in range(N_DECODE):
            jcaches.append(_cache_np(jeng.cache))
            nxt, lg = jeng.step(np.array(feed[-1:], np.int32))
            jstep.append(np.asarray(lg)[0])
            feed.append(int(np.asarray(nxt)[0]))

        pmodel, pgf = load_llama(path, device="cpu")
        pgf.close()
        global_profile.reset()
        peng = LlamaEngine(pmodel, prefill_chunk=64)
        plogits = peng.prefill(prompt)[0].numpy()
        ptok0 = int(np.argmax(plogits))
        _load_cache(peng, jcache0)
        ptoks = peng.decode_n([tok0], N_DECODE)[:, 0].tolist()
        peng.reset()
        peng.prefill(prompt)
        pstep = []
        for t, cache in zip(feed, jcaches):
            _load_cache(peng, cache)
            pstep.append(peng.step(torch.tensor([t]))[1][0].numpy())
        tiers = global_profile.tier_summary()
        np_params = _np_params(jmodel.params)
    return {"jax": (jlogits, tok0, jtoks, jstep), "port": (plogits, ptok0, ptoks, pstep),
            "tiers": tiers, "np_params": np_params, "port_params": pmodel.params}


def _check_prefill(runs):
    jlogits, plogits = runs["jax"][0], runs["port"][0]
    assert plogits.shape == jlogits.shape == (DEFAULT_CFG.vocab_size,)
    assert np.max(np.abs(plogits - jlogits)) <= 1e-3 * np.max(np.abs(jlogits))


def _check_steps(runs, rtol=1e-5):
    errs = []
    for i, (got, want) in enumerate(zip(runs["port"][3], runs["jax"][3])):
        assert np.all(np.isfinite(got))
        errs.append(np.max(np.abs(got - want)) / np.max(np.abs(want)))
        assert errs[-1] <= rtol, i
    print(f"decode steps: max|diff| / max|logit| up to {max(errs):.3g} (bound {rtol:.0e})")


def _check_greedy_tokens(runs, rtol=1e-3):
    jlogits, tok0, jtoks, jstep = runs["jax"]
    _, ptok0, ptoks, _ = runs["port"]
    bound = 1e-3 * np.max(np.abs(jlogits))
    if _gap(jlogits) < bound:
        print(f"prefill top-2 gap {_gap(jlogits):.3g} < {bound:.3g}: no token compared")
        return
    assert ptok0 == tok0
    gaps = [_gap(lg) for lg in jstep]
    n_cmp = next((i for i, g in enumerate(gaps) if g < rtol * np.max(np.abs(jstep[i]))),
                 N_DECODE)
    print(f"greedy tokens compared over {n_cmp} of {N_DECODE} steps")
    assert ptoks[:n_cmp] == jtoks[:n_cmp]


def test_default_prefill_logits_match_jax(default_runs):
    _check_prefill(default_runs)


def test_default_step_logits_match_jax(default_runs):
    """Decode through K7 + K6d and the M = 1 logits through K1, each step on
    the JAX cache of that step: within 1e-5 * max|logit| (f32 sums in another
    order; the logits' int8 activations are the same)."""
    _check_steps(default_runs)


def test_default_greedy_tokens_match_jax(default_runs):
    _check_greedy_tokens(default_runs)


def test_q8_default_prefill_logits_match_jax(q8_runs):
    """The 64-row prefill chunk through K2q8 and K3: within 1e-3 * max|logit|."""
    _check_prefill(q8_runs)


def test_q8_default_step_logits_match_jax(q8_runs):
    """Decode through K7 (Q8_0) + K6a and the M = 1 logits through K1q8, each
    step on the JAX cache of that step: within 1e-5 * max|logit|."""
    _check_steps(q8_runs)


def test_q8_default_greedy_tokens_match_jax(q8_runs):
    """Greedy decode_n through K5q8, compared as at Q4_0."""
    _check_greedy_tokens(q8_runs)


def test_q8_default_run_takes_the_default_tier(q8_runs):
    """The path JAX takes at Q8_0, as placement counts of plain versions:
    K7 and K6a per layer and step, K5q8 per greedy step, K1q8 per step()
    logits, K2q8 for the prefill chunks, K3; no Q4_0 kernel, no K4."""
    tiers = q8_runs["tiers"]
    n = 2 * N_DECODE * DEFAULT_CFG.n_layers
    assert tiers["attn_block_q8"] == {"ref": n}
    assert tiers["fused_ffn_norm_q8"] == {"ref": n}
    assert tiers["qmatmul_greedy_q8"] == {"ref": N_DECODE}
    assert tiers["qmatmul_i8_q8"] == {"ref": N_DECODE}
    assert tiers["qmatmul_q8"]["ref"] > 0 and tiers["attention"]["ref"] > 0
    assert not set(tiers) & {"attn_block", "fused_ffn_norm", "qmatmul_greedy", "qmatmul_i8",
                             "qmatmul", "decode_attention"}, tiers


def test_q8_params_from_jax_are_bit_exact(q8_runs):
    """params_from_jax on the JAX Q8_0 model (w_gate_up part-padded and split
    at n // 2) and the port's own GGUF load both give the JAX package's
    dequantized weights bit for bit."""
    np_params = q8_runs["np_params"]
    conv = params_from_jax(np_params, DEFAULT_CFG, device="cpu")
    for src in (conv, q8_runs["port_params"]):
        for lj, lp in zip(np_params["layers"], src["layers"]):
            for key in ("wqkv", "wo", "w_down"):
                assert lp[key].kind == "q8_0"
                assert _bits(lp[key].dequant()) == _bits(dequant_packed(lj[key]))
            gu = dequant_packed(lj["w_gate_up"])            # [2 * f_pad, d], part-padded
            half, f = gu.shape[0] // 2, DEFAULT_CFG.d_ff
            want = np.concatenate([gu[:f], gu[half:half + f]])
            assert _bits(lp["w_gate_up"].dequant()) == _bits(want)
        assert _bits(src["lm_head"].dequant()) == _bits(dequant_packed(np_params["lm_head"]))


def _bits(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32).tobytes()


def test_default_run_takes_the_default_tier(default_runs):
    """The port's placement shows the JAX default tier's kernels, as plain
    versions on the CPU: K7, K6d, K5 (greedy decode_n), K1 (step logits), K2
    (the 64-row prefill chunk), and K3; no K4 (batch-1 decode is K7)."""
    tiers = default_runs["tiers"]
    n = 2 * N_DECODE * DEFAULT_CFG.n_layers
    assert tiers["attn_block"] == {"ref": n}
    assert tiers["fused_ffn_norm"] == {"ref": n}
    assert tiers["qmatmul_greedy"] == {"ref": N_DECODE}
    assert tiers["qmatmul_i8"] == {"ref": N_DECODE}
    assert tiers["qmatmul"]["ref"] > 0 and tiers["attention"]["ref"] > 0
    assert "decode_attention" not in tiers
    assert all(set(t) == {"ref"} or set(t) == {"torch"} for t in tiers.values()), tiers


@pytest.mark.parametrize("chunk,tier", [(16, "qmatmul_i8"), (64, "qmatmul")])
def test_default_prefill_head_tier_matches_jax(tmp_path, chunk, tier):
    """The prefill head takes the tier of the whole chunk, as the JAX engine
    computes it over the chunk: int8 activations for <= 32 rows (K1), f32
    dequant above (K2); logits within 1e-3 * max|logit| either way."""
    path = str(tmp_path / "d256_q4.gguf")
    write_synthetic_llama_gguf(path, PREFILL_CFG, seed=12)
    prompt = np.random.default_rng(7).integers(0, PREFILL_CFG.vocab_size, PROMPT_LEN)
    with pytest.MonkeyPatch.context() as mp:
        _set_flags(mp, DEFAULT_FLAGS)
        jmodel, jgf = jax_load_llama(path)
        jgf.close()
        jlogits = np.asarray(JaxEngine(jmodel, prefill_chunk=chunk).prefill(prompt))[0]
        pmodel, pgf = load_llama(path, device="cpu")
        pgf.close()
        global_profile.reset()
        plogits = LlamaEngine(pmodel, prefill_chunk=chunk).prefill(prompt)[0].numpy()
        tiers = global_profile.tier_summary()
    n_chunks = -(-PROMPT_LEN // chunk)
    assert set(tiers) & {"qmatmul", "qmatmul_i8"} == {tier}
    assert tiers[tier]["ref"] == n_chunks * (4 * PREFILL_CFG.n_layers + 1)
    assert np.max(np.abs(plogits - jlogits)) <= 1e-3 * np.max(np.abs(jlogits))


def test_default_small_chunk_prefill_fuses_the_ffn_as_jax(tmp_path):
    """Prefill chunks of <= 32 rows at a width the JAX package fuses the FFN
    at (d 512): JAX's `_layer_step` runs rmsnorm, its f32 fused FFN K6b and
    the residual there, and so does the port, and the other projections take
    K1 on both sides (the placement counts). The logits agree within 1e-2 * max|logit|, not the 1e-3 of the
    f32 paths: at this config one rounding flip of an int8 activation or a
    bf16 cache value moves them by 4e-3 to 8e-3 of max|logit|, and a 1e-7
    relative perturbation of the port's own embeddings causes such a flip
    in most draws (PERF.md). test_default_layer_step_ffn_matches_jax holds
    the FFN of the same path to 1e-5 on shared inputs."""
    path = str(tmp_path / "d512_q4.gguf")
    write_synthetic_llama_gguf(path, DEFAULT_CFG, seed=13)
    prompt = np.random.default_rng(8).integers(0, DEFAULT_CFG.vocab_size, PROMPT_LEN)
    with pytest.MonkeyPatch.context() as mp:
        _set_flags(mp, DEFAULT_FLAGS)
        jmodel, jgf = jax_load_llama(path)
        jgf.close()
        jlogits = np.asarray(JaxEngine(jmodel, prefill_chunk=CHUNK).prefill(prompt))[0]
        pmodel, pgf = load_llama(path, device="cpu")
        pgf.close()
        global_profile.reset()
        plogits = LlamaEngine(pmodel, prefill_chunk=CHUNK).prefill(prompt)[0].numpy()
        tiers = global_profile.tier_summary()
    n_chunks, n_layers = -(-PROMPT_LEN // CHUNK), DEFAULT_CFG.n_layers
    assert tiers["fused_ffn"] == {"ref": n_chunks * n_layers}
    assert tiers["qmatmul_i8"] == {"ref": n_chunks * (2 * n_layers + 1)}
    assert "qmatmul" not in tiers and "fused_ffn_norm" not in tiers
    assert np.all(np.isfinite(plogits))
    assert np.max(np.abs(plogits - jlogits)) <= 1e-2 * np.max(np.abs(jlogits))


@pytest.mark.parametrize("rows", [1, 16, 32, 33])
def test_default_layer_step_ffn_matches_jax(tmp_path, rows):
    """The FFN half of `_layer_step` (prefill chunks, batch > 1 decode) on
    shared inputs with the loaded d 512 weights, under the default flags:
    for <= 32 rows both run rmsnorm, the f32 fused FFN K6b (dispatch.fused_ffn)
    and the residual; for 33 rows both compose f32 K2 projections. Within 1e-5 * max|out|: f32 on both sides. (A flip-free
    check: the whole layer also rounds K/V to bf16 and att to int8, which
    turn f32 summation-order differences into rounding flips.)"""
    import jax.numpy as jnp
    from zgml_tpu.models.llama import _project
    from zgml_tpu.ops import dispatch as jops
    from zgml_tpu.ops import refs as jrefs

    from zgml_tpu_torch.models.llama import _ffn

    cfg = DEFAULT_CFG
    path = str(tmp_path / "d512_q4.gguf")
    write_synthetic_llama_gguf(path, cfg, seed=13)
    x = np.random.default_rng(rows).standard_normal((1, rows, cfg.d_model)).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        _set_flags(mp, DEFAULT_FLAGS)
        jmodel, jgf = jax_load_llama(path)
        jgf.close()
        jl = jmodel.params["layers"][1]
        jx = jnp.asarray(x)
        h = jops.rmsnorm(jx, jl["ffn_norm"], cfg.rms_norm_eps)
        ff = jops.fused_ffn(h, jl["w_gate_up"], jl["w_down"])      # as llama.py:326-340
        assert (ff is None) == (rows > 32)
        if ff is None:
            gu = _project(h, jl["w_gate_up"])
            ff = _project(jrefs.swiglu_ref(gu[..., :cfg.d_ff], gu[..., cfg.d_ff:]),
                          jl["w_down"])
        want = np.asarray(jx + ff)
        pmodel, pgf = load_llama(path, device="cpu")
        pgf.close()
        global_profile.reset()
        got = _ffn(cfg, torch.from_numpy(x), pmodel.params["layers"][1],
                   after_attn_block=False).numpy()
        tiers = global_profile.tier_summary()
    assert tiers == ({"rmsnorm": {"torch": 1}, "fused_ffn": {"ref": 1}} if rows <= 32 else
                     {"rmsnorm": {"torch": 1}, "qmatmul": {"ref": 2}})
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))


def test_i8a_step_logits_match_jax(i8a_runs):
    """The int8 decode tier forced on at d 512 (K7 `a_i8` + K6c per layer),
    each step on the JAX cache of that step: within 1e-2 * max|logit|. The
    prefill (one 64-row chunk, f32) is held to 1e-3 as on the default tier.
    Before the port read ZGML_TPU_ATTN_I8A / ZGML_TPU_FFN_I8A this failed:
    the port ran f32 K7 and K6d where JAX quantized."""
    _check_prefill(i8a_runs)
    _check_steps(i8a_runs, rtol=I8_RTOL)


def test_i8a_greedy_tokens_match_jax(i8a_runs):
    """8 greedy tokens equal to JAX's, up to the first step whose JAX top-2
    gap is below the int8 bound (a tie within a rounding flip)."""
    _check_greedy_tokens(i8a_runs, rtol=I8_RTOL)


def test_i8a_run_takes_the_int8_tier(i8a_runs):
    """Placement: K7 in its int8 mode and K6c per layer and step; no f32 K7
    and no K6d."""
    tiers = i8a_runs["tiers"]
    n = 2 * N_DECODE * DEFAULT_CFG.n_layers
    assert tiers["attn_block_i8"] == {"ref": n}
    assert tiers["fused_ffn_norm_i8"] == {"ref": n}
    assert not set(tiers) & {"attn_block", "fused_ffn_norm"}, tiers


def test_layer_ffn_step_logits_match_jax(layer_ffn_runs):
    """ZGML_TPU_LAYER_FFN=1 at the int8 tier: JAX's K7 runs the FFN as its
    f32 phase E, so the port runs K7 with its phase E (K6d's f32 function
    inside the launch, not K6c); each step from the JAX cache of that step
    within 1e-5 * max|logit|, each layer's placement one attn_block_i8_ffn
    and no separate FFN. Before the port read the flag it ran K6c and its
    step sat 1.43e-2 * max|logit| away (ROADMAP C.1)."""
    _check_steps(layer_ffn_runs)
    tiers = layer_ffn_runs["tiers"]
    n = 2 * N_DECODE * DEFAULT_CFG.n_layers
    assert tiers["attn_block_i8_ffn"] == {"ref": n}
    assert not set(tiers) & {"attn_block_i8", "fused_ffn_norm", "fused_ffn_norm_i8"}, tiers


@pytest.mark.parametrize("attn_i8a", ["1", "0"])
def test_i8a_layer_halves_match_jax(tmp_path, monkeypatch, attn_i8a):
    """Each half of a decode layer on shared inputs with the loaded d 512
    weights, ZGML_TPU_FFN_I8A=1 and ZGML_TPU_ATTN_I8A as given, on both
    sides: JAX's `attn_block_step` (interpret) and `_ffn_after_attn` against
    the port's dispatch.attn_block and `_ffn(after_attn_block=True)`, within
    1e-5 * max|out|, with the int8 activations equal to JAX's pre-pass bit
    for bit. Which mode ran is read on both sides: the port's placement
    counts and the JAX kernels' own calls (`_layer_call`'s a_i8, the int8
    FFN's `_ffn_q4n_i8`). ZGML_TPU_ATTN_I8A=0 brings back the f32 K7 on both."""
    import jax.numpy as jnp
    from test_torch_layer import jax_normed_i8
    from zgml_tpu.models.llama import _ffn_after_attn
    from zgml_tpu.ops import ffn as jffn
    from zgml_tpu.ops import layerkernel as jlk
    from zgml_tpu.ops import refs as jrefs

    from zgml_tpu_torch.models.llama import _ffn
    from zgml_tpu_torch.ops import dispatch, refs
    from zgml_tpu_torch.ops.qmatmul import rmsnorm_quantize_ref

    cfg, li, pos = DEFAULT_CFG, 1, 37
    hd, hkv = cfg.head_dim, cfg.n_kv_heads
    path = str(tmp_path / "d512_q4.gguf")
    write_synthetic_llama_gguf(path, cfg, seed=11)
    _set_flags(monkeypatch, {**I8A_FLAGS, "ZGML_TPU_ATTN_I8A": attn_i8a})
    seen = []
    layer_call, ffn_i8 = jlk._layer_call, jffn._ffn_q4n_i8

    def spy_layer(*a, **kw):
        seen.append(("attn_i8", kw["a_i8"]))
        return layer_call(*a, **kw)

    def spy_ffn(*a, **kw):
        seen.append(("ffn_i8", True))
        return ffn_i8(*a, **kw)
    monkeypatch.setattr(jlk, "_layer_call", spy_layer)
    monkeypatch.setattr(jffn, "_ffn_q4n_i8", spy_ffn)

    jmodel, jgf = jax_load_llama(path)
    jgf.close()
    pmodel, pgf = load_llama(path, device="cpu")
    pgf.close()
    jl, pl = jmodel.params["layers"][li], pmodel.params["layers"][li]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 1, cfg.d_model)).astype(np.float32)
    shape = (cfg.n_layers, 1, hkv, cfg.max_seq_len, hd)
    ck = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.5).bfloat16()
    cv = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.5).bfloat16()
    cos, sin = jrefs.rope_cos_sin(jnp.asarray([pos]), hd, cfg.rope_base)
    jx, jk, jv, _, _, _ = jlk.attn_block_step(
        jmodel.cfg, jl, jnp.asarray(x), jnp.asarray(ck.float().numpy(), jnp.bfloat16),
        jnp.asarray(cv.float().numpy(), jnp.bfloat16), pos,
        jnp.concatenate([cos, cos], axis=1), jnp.concatenate([-sin, sin], axis=1),
        kv_layer=li)
    x_mid = np.array(jx)                             # the FFN half's shared input
    jy = np.asarray(_ffn_after_attn(jmodel.cfg, jl, jnp.asarray(x_mid), None))
    assert seen == [("attn_i8", attn_i8a == "1"), ("ffn_i8", True)]

    global_profile.reset()
    pcos, psin = refs.rope_cos_sin(torch.tensor([pos]), hd, cfg.rope_base)
    got = dispatch.attn_block(torch.from_numpy(x), pl["attn_norm"], pl["wqkv"], pl["wo"], ck, cv,
                              li, torch.tensor([pos], dtype=torch.int32), pcos, psin,
                              cfg.n_heads, hkv, cfg.rms_norm_eps)
    py = _ffn(cfg, torch.from_numpy(x_mid), pl, after_attn_block=True)
    k7 = "attn_block_i8" if attn_i8a == "1" else "attn_block"
    assert global_profile.tier_summary() == {k7: {"ref": 1}, "fused_ffn_norm_i8": {"ref": 1}}
    for g, w in ((got[0], jx), (got[1], jk), (got[2], jv), (py, jy)):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.max(np.abs(g.numpy() - w)) <= 1e-5 * np.max(np.abs(w))
    for row, gamma in ((x, "attn_norm"), (x_mid, "ffn_norm")):
        jq, js = jax_normed_i8(row, np.asarray(jl[gamma]), cfg.rms_norm_eps)
        pq, ps = rmsnorm_quantize_ref(torch.from_numpy(row), pl[gamma], cfg.rms_norm_eps)
        assert np.array_equal(pq.numpy(), jq) and np.array_equal(ps.numpy(), js)


# -- the JAX per-op kernel switches (ROADMAP C.3) -------------------------------
# Each switch, set around both packages on the default tier at d 512 Q4_0
# (seed 11): the port takes the JAX package's path for it. The int8-cache
# case runs batch 2 (batch-1 decode is K7's, which decode_attention does not
# gate), where JAX's decode over the int8 cache, switched off, dequantizes the
# cache and attends with the unquantized q.
SWITCHES = {
    "kernels_ref": {"ZGML_TPU_KERNELS": "ref"},
    "qmatmul": {"ZGML_TPU_KERNELS_DISABLE": "qmatmul"},
    "attention": {"ZGML_TPU_KERNELS_DISABLE": "attention"},
    "decode_attention": {"ZGML_TPU_KERNELS_DISABLE": "decode_attention"},
    "attn_block": {"ZGML_TPU_KERNELS_DISABLE": "attn_block"},
    "decode_attention_kv8": {"ZGML_TPU_KERNELS_DISABLE": "decode_attention"},
}
# Step bounds other than 1e-5: a switch whose path keeps an int8 tier takes
# the whole-model int8 bound (I8_RTOL): the int8 cache, and attn_block,
# whose decode layers then project their M = 1 rows through K1, int8
# activations of rows the two sides sum in another order (measured 8.3e-3
# at step 7). ZGML_TPU_KERNELS=ref has no int8 tier, but with K7 off the
# token's own K / V are written to the bf16 cache before attending (JAX's
# ZGML_TPU_ATTN_BLOCK=0 path), so each side rounds its own f32 row to bf16,
# and a one-ulp flip there moves the step (measured: one of the 256 v values
# of the row, 4.2e-5 * max|logit|): the prefill's bound
SWITCH_RTOL = {"decode_attention_kv8": I8_RTOL, "attn_block": I8_RTOL, "kernels_ref": 1e-3}
# placement names each switch must not show (the kernels it turns off) and
# must show (the path JAX takes instead, or the kernels it keeps)
SWITCH_TIERS = {
    "kernels_ref": ({"attn_block", "fused_ffn_norm", "fused_ffn", "qmatmul_i8",
                     "qmatmul_greedy"}, {"decode_attention", "qmatmul", "attention"}),
    "qmatmul": ({"qmatmul_i8", "qmatmul_greedy"}, {"attn_block", "fused_ffn_norm", "qmatmul"}),
    "attention": (set(), {"attention", "attn_block"}),
    "decode_attention": ({"decode_attention"}, {"attn_block", "qmatmul_greedy"}),
    "attn_block": ({"attn_block", "fused_ffn_norm"}, {"decode_attention", "fused_ffn"}),
    "decode_attention_kv8": ({"attn_block_kv8", "decode_attention"},
                             {"decode_attention_q8", "flash_attention_q8"}),
}


def _kv8_switch_run(tmp_path_factory, flags, batch=2):
    """_default_runs over the int8 cache at batch 2: the prefill logits, and
    each decode step of the port from the JAX cache of that step
    (cache_from_jax), fed JAX's greedy tokens."""
    from zgml_tpu_torch.quant import kv_cache
    path = str(tmp_path_factory.mktemp("torch_switch") / "d512_q4_kv8.gguf")
    write_synthetic_llama_gguf(path, DEFAULT_CFG, quant=GGMLType.Q4_0, seed=11)
    prompt = np.random.default_rng(6).integers(0, DEFAULT_CFG.vocab_size, (batch, PROMPT_LEN))
    with pytest.MonkeyPatch.context() as mp:
        _set_flags(mp, flags)
        jmodel, jgf = jax_load_llama(path)
        jgf.close()
        jeng = JaxEngine(jmodel, batch=batch, prefill_chunk=64, cache_dtype="int8",
                         donate_cache=False)
        jlogits = np.asarray(jeng.prefill(prompt))
        tok, feed, jstep, jcaches = np.argmax(jlogits, -1).astype(np.int32), [], [], []
        for _ in range(N_DECODE):
            jcaches.append({k: [tuple(np.asarray(a) for a in layer) for layer in v]
                            for k, v in jeng.cache.items()})
            feed.append(tok)
            nxt, lg = jeng.step(tok)
            jstep.append(np.asarray(lg))
            tok = np.asarray(nxt)
        pmodel, pgf = load_llama(path, device="cpu")
        pgf.close()
        global_profile.reset()
        peng = LlamaEngine(pmodel, batch=batch, prefill_chunk=64, cache_dtype="int8")
        plogits = peng.prefill(prompt).numpy()
        pstep = []
        for t, cache in zip(feed, jcaches):
            for k, v in kv_cache.cache_from_jax(cache, device="cpu").items():
                peng.cache[k].copy_(v)
            pstep.append(peng.step(torch.from_numpy(t.astype(np.int64)))[1].numpy())
        tiers = global_profile.tier_summary()
    return {"jax": (jlogits, jstep), "port": (plogits, pstep), "tiers": tiers}


@pytest.fixture(scope="module", params=list(SWITCHES))
def switch_runs(request, tmp_path_factory):
    flags = {**DEFAULT_FLAGS, **SWITCHES[request.param]}
    if request.param.endswith("_kv8"):
        return request.param, _kv8_switch_run(tmp_path_factory, flags)
    return request.param, _default_runs(tmp_path_factory, GGMLType.Q4_0, seed=11, flags=flags)


def test_kernel_switches_match_jax(switch_runs):
    """ROADMAP C.3: under each JAX per-op switch the port takes the JAX
    package's path. Prefill logits within 1e-3 * max|logit| (the two
    prefills' K/V round to bf16 apart, test_default_prefill_logits_match_jax);
    each decode step from the JAX cache of that step within 1e-5 *
    max|logit| (SWITCH_RTOL: 1e-2 where an int8 tier stays, 1e-3 where only
    the token's own K / V round to bf16 before attention); greedy tokens equal (from
    the shared cache, up to the first step whose JAX top-2 gap is under the
    step bound); the placement shows the switched kernels gone and the path
    JAX takes instead."""
    name, runs = switch_runs
    rtol = SWITCH_RTOL.get(name, 1e-5)
    tiers = runs["tiers"]
    absent, present = SWITCH_TIERS[name]
    assert not absent & set(tiers), tiers
    assert present <= set(tiers), tiers
    assert all(set(t) <= {"ref", "torch"} for t in tiers.values()), tiers
    if name.endswith("_kv8"):
        (jlogits, jstep), (plogits, pstep) = runs["jax"], runs["port"]
        assert np.max(np.abs(plogits - jlogits)) <= I8_RTOL * np.max(np.abs(jlogits))
        for got, want in zip(pstep, jstep):
            assert np.max(np.abs(got - want)) <= rtol * np.max(np.abs(want))
            for row in range(want.shape[0]):
                if _gap(want[row]) >= rtol * np.max(np.abs(want[row])):
                    assert np.argmax(got[row]) == np.argmax(want[row])
        return
    _check_prefill(runs)
    _check_steps(runs, rtol)
    _check_greedy_tokens(runs, rtol)
