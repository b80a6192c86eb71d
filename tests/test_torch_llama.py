"""The port's whole slice against the JAX package on tiny Q4_0 models.

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
    16-row prefill chunks (JAX's K6b, the port's K6d) at d 512.

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
from zgml_tpu.runtime.engine import LlamaEngine as JaxEngine

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
PROMPT_LEN, CHUNK, N_DECODE = 20, 16, 8


def _set_flags(mp, flags):
    for k in SLICE_FLAGS:
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
        port_conv = _port_run(LlamaModel(cfg, params_from_jax(np_params, cfg)))
        pmodel, pgf = load_llama(path)
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
                            np.full((n, k // 32), 0.01, np.float16))
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
    path = str(tmp_path_factory.mktemp("torch_default") / "d512_q4.gguf")
    write_synthetic_llama_gguf(path, DEFAULT_CFG, seed=11)
    prompt = np.random.default_rng(6).integers(0, DEFAULT_CFG.vocab_size, PROMPT_LEN)
    with pytest.MonkeyPatch.context() as mp:
        _set_flags(mp, DEFAULT_FLAGS)
        jmodel, jgf = jax_load_llama(path)
        jgf.close()
        assert "ffn_q4n" in jmodel.params["layers"][0]   # the JAX decode FFN is K6d here
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

        pmodel, pgf = load_llama(path)
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
    return {"jax": (jlogits, tok0, jtoks, jstep), "port": (plogits, ptok0, ptoks, pstep),
            "tiers": tiers}


def test_default_prefill_logits_match_jax(default_runs):
    jlogits, plogits = default_runs["jax"][0], default_runs["port"][0]
    assert plogits.shape == jlogits.shape == (DEFAULT_CFG.vocab_size,)
    assert np.max(np.abs(plogits - jlogits)) <= 1e-3 * np.max(np.abs(jlogits))


def test_default_step_logits_match_jax(default_runs):
    """Decode through K7 + K6d and the M = 1 logits through K1, each step on
    the JAX cache of that step: within 1e-5 * max|logit| (f32 sums in another
    order; the logits' int8 activations are the same)."""
    for i, (got, want) in enumerate(zip(default_runs["port"][3], default_runs["jax"][3])):
        assert np.all(np.isfinite(got))
        assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want)), i


def test_default_greedy_tokens_match_jax(default_runs):
    jlogits, tok0, jtoks, jstep = default_runs["jax"]
    _, ptok0, ptoks, _ = default_runs["port"]
    bound = 1e-3 * np.max(np.abs(jlogits))
    if _gap(jlogits) < bound:
        print(f"prefill top-2 gap {_gap(jlogits):.3g} < {bound:.3g}: no token compared")
        return
    assert ptok0 == tok0
    gaps = [_gap(lg) for lg in jstep]
    n_cmp = next((i for i, g in enumerate(gaps) if g < 1e-3 * np.max(np.abs(jstep[i]))),
                 N_DECODE)
    assert ptoks[:n_cmp] == jtoks[:n_cmp]


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
        pmodel, pgf = load_llama(path)
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
    at (d 512): JAX's `_layer_step` runs its f32 fused FFN there, the port
    K6d, and the other projections take K1 on both sides (the placement
    counts). The logits agree within 1e-2 * max|logit|, not the 1e-3 of the
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
        pmodel, pgf = load_llama(path)
        pgf.close()
        global_profile.reset()
        plogits = LlamaEngine(pmodel, prefill_chunk=CHUNK).prefill(prompt)[0].numpy()
        tiers = global_profile.tier_summary()
    n_chunks, n_layers = -(-PROMPT_LEN // CHUNK), DEFAULT_CFG.n_layers
    assert tiers["fused_ffn_norm"] == {"ref": n_chunks * n_layers}
    assert tiers["qmatmul_i8"] == {"ref": n_chunks * (2 * n_layers + 1)}
    assert "qmatmul" not in tiers
    assert np.all(np.isfinite(plogits))
    assert np.max(np.abs(plogits - jlogits)) <= 1e-2 * np.max(np.abs(jlogits))


@pytest.mark.parametrize("rows", [1, 16, 32, 33])
def test_default_layer_step_ffn_matches_jax(tmp_path, rows):
    """The FFN half of `_layer_step` (prefill chunks, batch > 1 decode) on
    shared inputs with the loaded d 512 weights, under the default flags:
    for <= 32 rows JAX runs rmsnorm, its f32 fused FFN (dispatch.fused_ffn)
    and the residual, the port one K6d; for 33 rows both compose f32 K2
    projections. Within 1e-5 * max|out|: f32 on both sides. (A flip-free
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
        pmodel, pgf = load_llama(path)
        pgf.close()
        global_profile.reset()
        got = _ffn(cfg, torch.from_numpy(x), pmodel.params["layers"][1],
                   after_attn_block=False).numpy()
        tiers = global_profile.tier_summary()
    assert tiers == ({"fused_ffn_norm": {"ref": 1}} if rows <= 32 else
                     {"rmsnorm": {"torch": 1}, "qmatmul": {"ref": 2}})
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))
