"""A GGUF that mixes quant kinds, as real llama.cpp files do, against the JAX
package on the CPU.

The file: a Q4_0 model (MIXED_CFG: d 512, 8 / 2 heads of 64, d_ff 1024, 4
layers, so every rule below meets a layer) with attn_v at Q8_0 in even
layers (q / k / v load unfused), ffn_up at Q8_0 in layers 1 mod 4 (gate /
up unfused), ffn_down at Q8_0 in layers 3 mod 4 (a Q4_0 gate|up beside a
Q8_0 down) and output.weight at Q8_0 (the smoke's mixed_tiny mix, at a width
K7 takes). What is held:

  - the layout: each layer's matmul keys and kinds are JAX's (wq / wk / wv
    where mixed, wqkv where uniform; the same for gate / up), and
    params_from_jax carries the JAX model across bit for bit;
  - the routes JAX takes: over the stacked bf16 cache no layer takes K7
    (all layers or none, llama.py:775-782; an unfused layer has no wo3),
    so every layer decodes through `_layer_step` (K4); over the int8 cache
    K7 runs on exactly the layers with a fused wqkv (the odd ones) and K8 at
    batch 1 on the others (llama.py:343-357); the FFN fuses only where
    gate|up and down share a kind (ffn_compatible); the greedy head is K5q8;
    ZGML_TPU_LAYER_FFN=1 changes nothing here (no layer has K7 beside a
    uniform Q4_0 FFN) and raises nothing; enable_stacked_decode and
    enable_tape_decode refuse, as JAX's do;
  - the logits: prefill within max(1e-3 * max|logit| over the bf16 cache or
    the repo's whole-model int8 bound 1e-2 over the int8 cache, 2 x the
    port's own move when the embedding rows of the prompt are scaled by 1 +
    1e-7 N(0, 1), 4 draws: the cache's bf16 rounding or int8 quantization
    of f32 sums in another order; 1.6e-3 measured over the int8 cache, where
    the embedding perturbation moved the port's own prefill by under 5e-4);
    each decode step from the JAX cache of
    that step within max(1e-5 * max|logit| over the bf16 cache or 1e-2 over
    the int8 cache, 2 x the port's own move when the embedding row of the
    step's token is scaled by 1 + 1e-7 N(0, 1), 4 draws): the unfused and
    mixed-kind FFNs are composed from K1 projections, whose int8
    activations of swiglu(gate, up) flip a level where gate and up differ
    by an ulp (the port's own step moved by up to 1.1e-2 of max|logit|
    under such a perturbation here, ROADMAP.md C's rounding flips), and
    K7-kv8 and K8 quantize q per head; greedy tokens from the JAX cache
    after the prefill equal JAX's up to the first step whose JAX top-2 gap
    is under that step's bound.

Both sides run under ZGML_TPU_SCALES=f16 and the prefill's f32 operands,
the JAX Pallas kernels in interpret mode (its ref tier of K8 is another
function, ROADMAP.md C), the port its plain versions.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zgml_tpu.io.llama_loader import load_llama as jax_load_llama
from zgml_tpu.runtime.engine import LlamaEngine as JaxEngine

from zgml_tpu_torch.io.gguf import GGMLType
from zgml_tpu_torch.io.llama_loader import load_llama, params_from_jax
from zgml_tpu_torch.models.llama import LlamaConfig
from zgml_tpu_torch.quant import kv_cache
from zgml_tpu_torch.quant.packed import PackedWeight
from zgml_tpu_torch.runtime.engine import LlamaEngine
from zgml_tpu_torch.runtime.profile import global_profile
from zgml_tpu_torch.utils.synthetic import write_synthetic_llama_gguf

torch.set_num_threads(1)

MIXED_CFG = LlamaConfig(vocab_size=96, d_model=512, n_heads=8, n_kv_heads=2, d_ff=1024,
                        n_layers=4, max_seq_len=96)
FLAGS = {"ZGML_TPU_SCALES": "f16", "ZGML_TPU_PREFILL_BF16": "0"}
CLEARED = ("ZGML_TPU_LAYER_FFN", "ZGML_TPU_ATTN_I8A", "ZGML_TPU_FFN_I8A", "ZGML_TPU_KERNELS",
           "ZGML_TPU_KERNELS_DISABLE", "ZGML_TPU_ATTN_BLOCK", "ZGML_TPU_I8DOT")
PREFILL_RTOL, STEP_RTOL = {"bf16": 1e-3, "int8": 1e-2}, {"bf16": 1e-5, "int8": 1e-2}
SENS_EPS, SENS_DRAWS, SENS_MARGIN = 1e-7, 4, 2.0
PROMPT_LEN, CHUNK, N_STEPS = 20, 64, 4
MATMUL_KEYS = ("wq", "wk", "wv", "wqkv", "wo", "w_gate", "w_up", "w_gate_up", "w_down")


def mixed_kinds(n_layers: int) -> dict:
    kinds = {"output.weight": GGMLType.Q8_0}
    for i in range(n_layers):
        if i % 2 == 0:
            kinds[f"blk.{i}.attn_v.weight"] = GGMLType.Q8_0
        if i % 4 == 1:
            kinds[f"blk.{i}.ffn_up.weight"] = GGMLType.Q8_0
        if i % 4 == 3:
            kinds[f"blk.{i}.ffn_down.weight"] = GGMLType.Q8_0
    return kinds


@pytest.fixture(scope="module")
def mixed_gguf(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mixed") / "mixed.gguf")
    write_synthetic_llama_gguf(path, MIXED_CFG, GGMLType.Q4_0, seed=17,
                               kinds=mixed_kinds(MIXED_CFG.n_layers))
    return path


def _set_flags(mp, flags):
    for k in CLEARED:
        mp.delenv(k, raising=False)
    for k, v in flags.items():
        mp.setenv(k, v)


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


def _kinds(layer) -> dict:
    return {k: (v.kind if hasattr(v, "kind") else "dense") for k, v in layer.items()
            if k in MATMUL_KEYS}


def test_layout_and_kinds_match_jax(mixed_gguf, monkeypatch):
    _set_flags(monkeypatch, FLAGS)
    jmodel, jgf = jax_load_llama(mixed_gguf)
    jgf.close()
    model, gf = load_llama(mixed_gguf, device="cpu")
    gf.close()
    for i, (lj, lp) in enumerate(zip(jmodel.params["layers"], model.params["layers"])):
        assert _kinds(lp) == _kinds(lj)
        assert ("wqkv" in lp) == (i % 2 == 1) and ("w_gate_up" in lp) == (i % 4 != 1)
    assert model.params["lm_head"].kind == jmodel.params["lm_head"].kind == "q8_0"
    assert not model.enable_stacked_decode() and not jmodel.enable_stacked_decode()
    assert not model.enable_tape_decode() and not jmodel.enable_tape_decode()


def test_params_from_jax_carries_a_mixed_model(mixed_gguf, monkeypatch):
    _set_flags(monkeypatch, FLAGS)
    jmodel, jgf = jax_load_llama(mixed_gguf)
    jgf.close()
    model, gf = load_llama(mixed_gguf, device="cpu")
    gf.close()
    conv = params_from_jax(_np_params(jmodel.params), model.cfg, device="cpu")
    pairs = list(zip(conv["layers"], model.params["layers"]))
    pairs.append(({"lm_head": conv["lm_head"]}, {"lm_head": model.params["lm_head"]}))
    for got, want in pairs:
        assert set(got) == set(want)
        for key, w in want.items():
            g = got[key]
            if isinstance(w, PackedWeight):
                assert (g.kind, g.n, g.k) == (w.kind, w.n, w.k), key
                assert torch.equal(g.qs, w.qs) and torch.equal(g.d.view(torch.int16),
                                                               w.d.view(torch.int16)), key
            else:
                assert torch.equal(g, w), key


def _port_cache(jcache, int8):
    if int8:
        return kv_cache.cache_from_jax({n: [tuple(np.asarray(a) for a in layer)
                                            for layer in jcache[n]] for n in ("k", "v")},
                                           device="cpu")
    return {n: torch.from_numpy(np.array(jcache[n].astype(jnp.float32))).to(torch.bfloat16)
            for n in ("k", "v")}


def _load(eng, cache):
    for k, v in cache.items():
        eng.cache[k].copy_(v)


def _gap(logits) -> float:
    top2 = np.sort(logits)[-2:]
    return float(top2[1] - top2[0])


@pytest.fixture(scope="module", params=[("bf16", "0"), ("bf16", "1"), ("int8", "0"),
                                        ("int8", "1")], ids=lambda p: f"{p[0]}-layer_ffn{p[1]}")
def runs(request, mixed_gguf):
    """Both packages on the mixed file: the prefill, decode steps fed the JAX
    greedy tokens each from the JAX cache of that step, and the port's
    greedy decode_n from the JAX cache after the prefill, with the port's
    placement counts of the steps and of decode_n."""
    cache_dtype, layer_ffn = request.param
    int8 = cache_dtype == "int8"
    prompt = np.random.default_rng(6).integers(0, MIXED_CFG.vocab_size, PROMPT_LEN)
    with pytest.MonkeyPatch.context() as mp:
        _set_flags(mp, {**FLAGS, "ZGML_TPU_LAYER_FFN": layer_ffn})
        jmodel, jgf = jax_load_llama(mixed_gguf)
        jgf.close()
        jeng = JaxEngine(jmodel, prefill_chunk=CHUNK,
                         cache_dtype="int8" if int8 else jnp.bfloat16)
        jpre = np.asarray(jeng.prefill(prompt))[0]
        feed, jsteps, jcaches = [int(np.argmax(jpre))], [], []
        for _ in range(N_STEPS):
            jcaches.append(_port_cache(jeng.cache, int8))
            nxt, lg = jeng.step(np.array(feed[-1:], np.int32))
            jsteps.append(np.asarray(lg)[0])
            feed.append(int(np.asarray(nxt)[0]))

        model, gf = load_llama(mixed_gguf, device="cpu")
        gf.close()
        peng = LlamaEngine(model, prefill_chunk=CHUNK, cache_dtype=cache_dtype)
        ppre = peng.prefill(prompt)[0].numpy()
        embd, gen = model.params["tok_embd"], torch.Generator().manual_seed(0)
        ids = sorted(set(prompt.tolist()))
        rows, pre_move = embd[ids].clone(), 0.0
        for _ in range(SENS_DRAWS):
            embd[ids] = rows * (1 + SENS_EPS * torch.randn(rows.shape, generator=gen))
            peng.reset()
            pre_move = max(pre_move, float(np.max(np.abs(peng.prefill(prompt)[0].numpy()
                                                          - ppre))))
        embd[ids] = rows
        peng.reset()
        peng.prefill(prompt)
        global_profile.reset()
        psteps, pos0 = [], peng.pos
        for i, (t, cache) in enumerate(zip(feed, jcaches)):
            _load(peng, cache)
            peng.pos = pos0 + i
            psteps.append(peng.step(torch.tensor([t]))[1][0].numpy())
        step_tiers = global_profile.tier_summary()
        moves = []
        for i, (t, cache) in enumerate(zip(feed, jcaches)):
            row, moved = embd[t].clone(), 0.0
            for _ in range(SENS_DRAWS):
                embd[t] = row * (1 + SENS_EPS * torch.randn(row.shape, generator=gen))
                _load(peng, cache)
                peng.pos = pos0 + i
                out = peng.step(torch.tensor([t]))[1][0].numpy()
                moved = max(moved, float(np.max(np.abs(out - psteps[i]))))
            embd[t] = row
            moves.append(moved)
        peng.reset()
        peng.prefill(prompt)
        _load(peng, jcaches[0])
        global_profile.reset()
        ptoks = peng.decode_n([feed[0]], N_STEPS)[:, 0].tolist()
        greedy_tiers = global_profile.tier_summary()
    bounds = [max(STEP_RTOL[cache_dtype] * np.max(np.abs(lg)), SENS_MARGIN * m)
              for lg, m in zip(jsteps, moves)]
    return dict(cache=cache_dtype, jax=(jpre, jsteps, feed[1:]), port=(ppre, psteps, ptoks),
                pre_bound=max(PREFILL_RTOL[cache_dtype] * np.max(np.abs(jpre)), SENS_MARGIN * pre_move), bounds=bounds, step_tiers=step_tiers, greedy_tiers=greedy_tiers)


def test_prefill_logits_match_jax(runs):
    jpre, ppre = runs["jax"][0], runs["port"][0]
    assert ppre.shape == jpre.shape == (MIXED_CFG.vocab_size,)
    err, scale = np.max(np.abs(ppre - jpre)), np.max(np.abs(jpre))
    print(f"{runs['cache']}: prefill {err / scale:.3g} of max|logit| (bound "
          f"{runs['pre_bound'] / scale:.3g})")
    assert err <= runs["pre_bound"]


def test_step_logits_match_jax(runs):
    for i, (got, want, bound) in enumerate(zip(runs["port"][1], runs["jax"][1],
                                               runs["bounds"])):
        assert np.all(np.isfinite(got))
        err = np.max(np.abs(got - want))
        scale = np.max(np.abs(want))
        print(f"{runs['cache']} step {i}: {err / scale:.3g} of max|logit| (bound "
              f"{bound / scale:.3g})")
        assert err <= bound


def test_greedy_tokens_match_jax(runs):
    jsteps, jtoks = runs["jax"][1], runs["jax"][2]
    n_cmp = next((i for i, (lg, b) in enumerate(zip(jsteps, runs["bounds"])) if _gap(lg) < b),
                 N_STEPS)
    assert runs["port"][2][:n_cmp] == jtoks[:n_cmp]


def test_routes_follow_jax(runs):
    """Per decode token (N_STEPS of them): over the bf16 cache 4 layers of
    K4 and no K7; over the int8 cache K7 on the 2 fused layers and K8 on the
    2 others; the FFN fused (K6b, rmsnorm outside) only in the layers whose
    gate|up and down share Q4_0 (0 and 2) and nowhere K7's phase E; K1q8 for
    wv, ffn_up, ffn_down and the head's logits; K5q8 for the greedy head."""
    n, steps, greedy = N_STEPS, runs["step_tiers"], runs["greedy_tiers"]
    for tiers in (steps, greedy):
        assert all(set(t) == {"ref"} for op, t in tiers.items()
                   if op not in ("rmsnorm", "rope", "matmul")), tiers
        assert not any(op.startswith("attn_block") and op.endswith("_ffn") for op in tiers)
        assert not {"fused_ffn_norm", "fused_ffn_norm_q8", "decode_attention"} & (
            set(tiers) if runs["cache"] == "int8" else set()), tiers
        assert tiers["fused_ffn"] == {"ref": 2 * n}
        if runs["cache"] == "int8":
            assert tiers["attn_block_kv8"] == {"ref": 2 * n}
            assert tiers["decode_attention_q8"] == {"ref": 2 * n}
        else:
            assert not any(op.startswith("attn_block") for op in tiers), tiers
            assert tiers["decode_attention"] == {"ref": 4 * n}
    # per step: wv in layers 0 and 2, ffn_up in layer 1, ffn_down in layer 3,
    # and the logits of step() through the Q8_0 head
    assert steps["qmatmul_i8_q8"] == {"ref": 5 * n}
    assert greedy["qmatmul_i8_q8"] == {"ref": 4 * n}
    assert greedy["qmatmul_greedy_q8"] == {"ref": n}


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
def test_serving_runs_a_mixed_model(mixed_gguf, monkeypatch, cache_dtype):
    """The server takes `_layer_step` only, unfused layers included: three
    requests through two slots, each stream bit-equal to the same request
    served alone (every kernel on the path computes a row from that row)."""
    from zgml_tpu_torch.runtime.serving import ContinuousBatchingEngine
    _set_flags(monkeypatch, FLAGS)
    model, gf = load_llama(mixed_gguf, device="cpu")
    gf.close()
    rng = np.random.default_rng(8)
    reqs = [(rng.integers(0, MIXED_CFG.vocab_size, n).tolist(), m)
            for n, m in ((5, 6), (19, 4), (9, 5))]

    def server():
        return ContinuousBatchingEngine(model, max_batch=2, prefill_chunk=16,
                                        cache_dtype=cache_dtype)
    outs = server().run(reqs)
    assert [len(outs[i]) for i in range(3)] == [m for _, m in reqs]
    for i, req in enumerate(reqs):
        assert server().run([req])[0] == outs[i]
