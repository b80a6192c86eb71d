"""K7's phase E (ZGML_TPU_LAYER_FFN=1) against the JAX package's
`_layer_kernel` with `has_ffn`, on the CPU.

JAX's has_ffn (layerkernel.py:758-765) runs a Q4_0 layer's FFN inside the
layer kernel, the f32 N-packed FFN whatever ZGML_TPU_FFN_I8A says. The port
places one K7 launch with its phase E per layer (counted attn_block_ffn, +
_i8 / _kv8 by mode) and no separate FFN; its plain version (the CPU tier)
is the chain attn_block_ref then fused_ffn_norm_ref. Held to JAX on shared
inputs per layer (within 1e-5 * max|out|, the JAX Pallas kernel in
interpret mode), over 8 greedy tokens and each decode step from the JAX
cache of that step, and over the int8 cache to the port's own chain K7 +
K6d bit for bit (the JAX int8-cache layer call is covered by
tests/test_torch_kvcache.py without phase E).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_llama import (DEFAULT_CFG, DEFAULT_FLAGS, I8A_FLAGS, N_DECODE,
                              _check_greedy_tokens, _check_prefill, _check_steps, _default_runs,
                              _set_flags)
from zgml_tpu.io.llama_loader import load_llama as jax_load_llama
from zgml_tpu.ops import layerkernel as jlk
from zgml_tpu.ops import refs as jrefs

from zgml_tpu_torch.io.gguf import GGMLType
from zgml_tpu_torch.io.llama_loader import load_llama
from zgml_tpu_torch.models import llama as tllama
from zgml_tpu_torch.ops import dispatch, refs
from zgml_tpu_torch.runtime.engine import LlamaEngine
from zgml_tpu_torch.runtime.profile import global_profile
from zgml_tpu_torch.utils.synthetic import write_synthetic_llama_gguf

torch.set_num_threads(1)
LAYER_FFN = {"ZGML_TPU_LAYER_FFN": "1"}


@pytest.fixture(scope="module")
def phase_e_runs(tmp_path_factory):
    """The default tier (f32 A phase at d 512, bf16 cache) with
    ZGML_TPU_LAYER_FFN=1 on both packages: prefill, 8 greedy tokens, and
    each decode step from the JAX cache of that step."""
    return _default_runs(tmp_path_factory, GGMLType.Q4_0, seed=11,
                         flags={**DEFAULT_FLAGS, **LAYER_FFN})


def test_phase_e_steps_match_jax(phase_e_runs):
    """Each decode step through K7-with-E (per layer) and the K1 head,
    within 1e-5 * max|logit| of JAX's, whose layer kernel ran has_ffn."""
    _check_prefill(phase_e_runs)
    _check_steps(phase_e_runs)


def test_phase_e_greedy_tokens_match_jax(phase_e_runs):
    _check_greedy_tokens(phase_e_runs)


def test_phase_e_placement(phase_e_runs):
    """One attn_block_ffn per layer per decode step, and no K6d / K6c / K7
    without E on decode (the prefill's FFN is K6b's, outside decode)."""
    tiers = phase_e_runs["tiers"]
    n = 2 * N_DECODE * DEFAULT_CFG.n_layers
    assert tiers["attn_block_ffn"] == {"ref": n}, tiers
    assert not set(tiers) & {"attn_block", "fused_ffn_norm", "fused_ffn_norm_i8"}, tiers


@pytest.mark.parametrize("attn_i8a", ["0", "1"])
def test_phase_e_layer_matches_jax(tmp_path, monkeypatch, attn_i8a):
    """One layer on shared inputs: JAX's attn_block_step with has_ffn (its
    `_layer_call` asked for the FFN phase, the step reports did_ffn) against
    dispatch.attn_block(..., ffn=...), x_out (the whole layer), k_cur and
    v_cur within 1e-5 * max|out|; with ZGML_TPU_ATTN_I8A=1 the int8 A phase
    and the f32 FFN (ZGML_TPU_FFN_I8A=1 changes nothing there), counted
    attn_block_i8_ffn."""
    cfg, li, pos = DEFAULT_CFG, 1, 37
    hd, hkv = cfg.head_dim, cfg.n_kv_heads
    path = str(tmp_path / "d512_q4.gguf")
    write_synthetic_llama_gguf(path, cfg, seed=11)
    _set_flags(monkeypatch, {**I8A_FLAGS, "ZGML_TPU_ATTN_I8A": attn_i8a, **LAYER_FFN})
    seen = []
    layer_call = jlk._layer_call

    def spy(*a, **kw):
        seen.append((kw["a_i8"], kw["has_ffn"]))
        return layer_call(*a, **kw)
    monkeypatch.setattr(jlk, "_layer_call", spy)
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
    jx, jk, jv, did_ffn, _, _ = jlk.attn_block_step(
        jmodel.cfg, jl, jnp.asarray(x), jnp.asarray(ck.float().numpy(), jnp.bfloat16),
        jnp.asarray(cv.float().numpy(), jnp.bfloat16), pos,
        jnp.concatenate([cos, cos], axis=1), jnp.concatenate([-sin, sin], axis=1),
        kv_layer=li)
    assert did_ffn and seen == [(attn_i8a == "1", True)]
    global_profile.reset()
    pcos, psin = refs.rope_cos_sin(torch.tensor([pos]), hd, cfg.rope_base)
    assert tllama._phase_e(cfg, pl)
    got = dispatch.attn_block(torch.from_numpy(x), pl["attn_norm"], pl["wqkv"], pl["wo"], ck, cv,
                              li, torch.tensor([pos], dtype=torch.int32), pcos, psin,
                              cfg.n_heads, hkv, cfg.rms_norm_eps,
                              (pl["ffn_norm"], pl["w_gate_up"], pl["w_down"]))
    k7 = "attn_block_i8_ffn" if attn_i8a == "1" else "attn_block_ffn"
    assert global_profile.tier_summary() == {k7: {"ref": 1}}
    for g, w in ((got[0], jx), (got[1], jk), (got[2], jv)):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.max(np.abs(g.numpy() - w)) <= 1e-5 * np.max(np.abs(w))


@pytest.mark.parametrize("attn_i8a", ["0", "1"])
def test_phase_e_over_the_int8_cache_is_the_chain(tmp_path, monkeypatch, attn_i8a):
    """Over the int8 cache the port's K7-with-E (attn_block_kv8_ffn /
    attn_block_i8_kv8_ffn) gives the logits of the chain K7 + K6d (the same
    engine with ZGML_TPU_LAYER_FFN=0 and ZGML_TPU_FFN_I8A=0) bit for bit,
    over a prompt and 8 greedy steps."""
    path = str(tmp_path / "d512_q4.gguf")
    write_synthetic_llama_gguf(path, DEFAULT_CFG, seed=12)
    prompt = np.random.default_rng(6).integers(0, DEFAULT_CFG.vocab_size, 20)
    runs = {}
    for name, flags in (("e", LAYER_FFN), ("chain", {"ZGML_TPU_FFN_I8A": "0"})):
        _set_flags(monkeypatch, {**DEFAULT_FLAGS, "ZGML_TPU_ATTN_I8A": attn_i8a, **flags})
        model, gf = load_llama(path, device="cpu")
        gf.close()
        eng = LlamaEngine(model, prefill_chunk=64, cache_dtype="int8")
        global_profile.reset()
        logits = eng.prefill(prompt)[0]
        steps, tok = [], int(torch.argmax(logits))
        for _ in range(N_DECODE):
            nxt, lg = eng.step(torch.tensor([tok]))
            steps.append(lg[0])
            tok = int(nxt[0])
        runs[name] = (steps, global_profile.tier_summary())
    (e_steps, e_tiers), (c_steps, c_tiers) = runs["e"], runs["chain"]
    mode = "attn_block" + ("_i8" if attn_i8a == "1" else "") + "_kv8"
    n = N_DECODE * DEFAULT_CFG.n_layers
    assert e_tiers[mode + "_ffn"] == {"ref": n} and mode not in e_tiers, e_tiers
    assert "fused_ffn_norm" not in e_tiers and c_tiers["fused_ffn_norm"] == {"ref": n}
    for a, b in zip(e_steps, c_steps):
        assert torch.equal(a, b)
