"""The f32 KV cache (the JAX package's init_cache(batch, jnp.float32)): the
port against the JAX package on the CPU.

The JAX side runs its Pallas kernels in interpret mode (tests/conftest.py),
the port its plain versions (CPU tensors), on the same inputs drawn from a
seed with numpy (or the same synthetic GGUF). Both packages read the JAX
flags, set around both sides: ZGML_TPU_SCALES=f16 and
ZGML_TPU_PREFILL_BF16 at 0 (the f32 operand function, where the two differ
only in the order of f32 sums) unless a test says otherwise; the i8a flags
explicitly where a test turns them on.

Bounds: K3 over f32 K / V within 1e-5 * max|o| in its f32 form, and in its
bf16 form within the flip-aware bound of tests/test_torch_prefill_bf16.py
(max(1e-5 * max|o|, 2 x the port's own move when its score scale moves by
2^-20 or 2^-18: a score an ulp off rounds p to the other bf16 neighbour);
K7 over the f32 cache within 1e-5 * max|out| on shared inputs (the int8 A
phase too: both quantize the same normed row), its written row equal to its
own k_cur / v_cur; the engines' prefill logits within 1e-3 * max|logit|
(tests/test_torch_llama.py's bound) and their decode steps, fed the same
tokens, within 1e-2 * max|logit| (the int8 projection tier's flips, ROADMAP
C), greedy tokens equal up to the first step whose JAX top-2 gap is under
that bound; the servers' and the GPT engines' greedy streams equal.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zgml_tpu.io.llama_loader import load_llama as jax_load_llama
from zgml_tpu.models import gpt as jgpt
from zgml_tpu.ops import attention as jattn
from zgml_tpu.ops import layerkernel as jlk
from zgml_tpu.ops import refs as jrefs
from zgml_tpu.runtime.engine import LlamaEngine as JaxEngine
from zgml_tpu.runtime.serving import ContinuousBatchingEngine as JaxServer

from zgml_tpu_torch.io.gguf import GGMLType
from zgml_tpu_torch.io.llama_loader import gpt_params_from_jax, load_llama
from zgml_tpu_torch.models.gpt import GPTConfig, GPTModel
from zgml_tpu_torch.models.llama import LlamaConfig
from zgml_tpu_torch.ops import attention, dispatch, refs
from zgml_tpu_torch.runtime.engine import LlamaEngine
from zgml_tpu_torch.runtime.profile import global_profile
from zgml_tpu_torch.runtime.serving import ContinuousBatchingEngine
from zgml_tpu_torch.utils.synthetic import TINY_TEST, write_synthetic_llama_gguf

torch.set_num_threads(1)

FLAGS = {"ZGML_TPU_SCALES": "f16", "ZGML_TPU_PREFILL_BF16": "0", "ZGML_TPU_ATTN_I8A": "0",
         "ZGML_TPU_FFN_I8A": "0", "ZGML_TPU_LAYER_FFN": "0"}
CFG = LlamaConfig(vocab_size=96, d_model=512, n_heads=8, n_kv_heads=2, d_ff=1024, n_layers=2,
                  max_seq_len=96)
I8_RTOL = 1e-2
FLIP_EPS = (2.0 ** -20, -2.0 ** -20, 2.0 ** -18, -2.0 ** -18)


@pytest.fixture
def flags(monkeypatch):
    for k, v in FLAGS.items():
        monkeypatch.setenv(k, v)
    return monkeypatch


def _close(got, want, rtol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = float(np.max(np.abs(got - want))), float(np.max(np.abs(want)))
    assert err <= rtol * scale, f"{what}: {err:.3g} > {rtol:g} x {scale:.3g}"


# -- K3 over f32 K / V ------------------------------------------------------------------

# b, hq, hkv, tq, cache rows, S, d, kv_len, q_offset, kv_row
K3_CASES = [(1, 8, 2, 16, 3, 128, 64, 48, 32, 2),
            (1, 4, 4, 32, 2, 512, 128, 416, 384, 1),
            (2, 8, 2, 12, 2, 64, 32, 30, 18, 0)]


@pytest.mark.parametrize("bf16", ["0", "1"], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,hq,hkv,tq,rows,s,d,kv_len,q_off,kv_row", K3_CASES)
def test_k3_over_f32_kv_matches_jax(flags, bf16, b, hq, hkv, tq, rows, s, d, kv_len, q_off,
                                    kv_row):
    """dispatch.flash_attention over f32 K / V (counted attention_f32kv, or
    attention_bf16_f32kv under ZGML_TPU_PREFILL_BF16=1) against JAX's
    flash_attention_pallas over the same f32 K / V, which casts them to its
    operand dtype."""
    flags.setenv("ZGML_TPU_PREFILL_BF16", bf16)
    rng = np.random.default_rng(s + kv_len + int(bf16))
    q = rng.standard_normal((b, hq, tq, d)).astype(np.float32)
    k, v = (rng.standard_normal((rows, hkv, s, d)).astype(np.float32) for _ in range(2))
    want = np.asarray(jattn.flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                   kv_len=kv_len, q_offset=q_off,
                                                   kv_row=kv_row if b == 1 else None))
    tq_, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    global_profile.reset()
    got = dispatch.flash_attention(tq_, tk, tv, kv_len, q_off, kv_row).numpy()
    name = "attention_bf16_f32kv" if bf16 == "1" else "attention_f32kv"
    assert global_profile.tier_summary() == {name: {"ref": 1}}
    if bf16 == "0":
        _close(got, want, 1e-5, "f32 form")
        return

    def port(scale):
        return attention.flash_attention_ref(tq_, tk, tv, kv_len, q_off, kv_row, bf16=True,
                                             scale=scale)
    base = port(1.0 / d ** 0.5)
    move = max(float((port((1 + e) / d ** 0.5) - base).abs().max()) for e in FLIP_EPS)
    bound = max(1e-5 * float(np.max(np.abs(want))), 2 * move)
    assert float(np.max(np.abs(got - want))) <= bound
    # the bf16 form over f32 K / V is the bf16 form over their bf16 roundings
    on_rounded = attention.flash_attention_ref(tq_, tk.bfloat16(), tv.bfloat16(), kv_len, q_off,
                                               kv_row, bf16=True)
    assert torch.equal(torch.from_numpy(got), on_rounded)


# -- K7 over the f32 cache --------------------------------------------------------------

@pytest.fixture(scope="module")
def d512_q4(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("f32_cache") / "d512_q4.gguf")
    write_synthetic_llama_gguf(path, CFG, seed=11)
    return path


@pytest.mark.parametrize("pos", [0, 37])
@pytest.mark.parametrize("a_i8,e", [("0", "0"), ("1", "0"), ("0", "1"), ("1", "1")],
                         ids=["f32", "i8", "f32_ffn", "i8_ffn"])
def test_k7_over_f32_cache_matches_jax(flags, d512_q4, a_i8, e, pos):
    """One layer on shared inputs: JAX's attn_block_step over a stacked f32
    cache (kv_layer) against dispatch.attn_block over the port's (counted
    attn_block(_i8)_f32kv(_ffn)), at both A phases (ZGML_TPU_ATTN_I8A) and
    with phase E (ZGML_TPU_LAYER_FFN): x_out, k_cur, v_cur within 1e-5 *
    max|out|; the port writes row pos of layer li as its k_cur / v_cur
    exactly and nothing else."""
    flags.setenv("ZGML_TPU_ATTN_I8A", a_i8)
    flags.setenv("ZGML_TPU_LAYER_FFN", e)
    cfg, li = CFG, 1
    hd, hkv = cfg.head_dim, cfg.n_kv_heads
    jmodel, jgf = jax_load_llama(d512_q4)
    jgf.close()
    pmodel, pgf = load_llama(d512_q4, device="cpu")
    pgf.close()
    jl, pl = jmodel.params["layers"][li], pmodel.params["layers"][li]
    rng = np.random.default_rng(4 + pos)
    x = rng.standard_normal((1, 1, cfg.d_model)).astype(np.float32)
    shape = (cfg.n_layers, 1, hkv, cfg.max_seq_len, hd)
    ck, cv = (rng.standard_normal(shape).astype(np.float32) * 0.5 for _ in range(2))
    cos, sin = jrefs.rope_cos_sin(jnp.asarray([pos]), hd, cfg.rope_base)
    jx, jk, jv, did_ffn, _, _ = jlk.attn_block_step(
        jmodel.cfg, jl, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv), pos,
        jnp.concatenate([cos, cos], axis=1), jnp.concatenate([-sin, sin], axis=1), kv_layer=li)
    assert did_ffn == (e == "1")
    tck, tcv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    pcos, psin = refs.rope_cos_sin(torch.tensor([pos]), hd, cfg.rope_base)
    ffn = (pl["ffn_norm"], pl["w_gate_up"], pl["w_down"]) if e == "1" else None
    global_profile.reset()
    got = dispatch.attn_block(torch.from_numpy(x), pl["attn_norm"], pl["wqkv"], pl["wo"], tck,
                              tcv, li, torch.tensor([pos], dtype=torch.int32), pcos, psin,
                              cfg.n_heads, hkv, cfg.rms_norm_eps, ffn)
    name = "attn_block" + ("_i8" if a_i8 == "1" else "") + "_f32kv" + ("_ffn" if ffn else "")
    assert global_profile.tier_summary() == {name: {"ref": 1}}
    for g, w, what in zip(got, (jx, jk, jv), ("x_out", "k_cur", "v_cur")):
        _close(g.numpy(), np.asarray(w), 1e-5, what)
    rows = torch.arange(cfg.max_seq_len) != pos
    for c, before, cur in ((tck, ck, got[1]), (tcv, cv, got[2])):
        assert torch.equal(c[li, 0, :, pos], cur[0, :, 0])
        assert torch.equal(c[:, :, :, rows], torch.from_numpy(before)[:, :, :, rows])
        assert torch.equal(c[1 - li], torch.from_numpy(before)[1 - li])


@pytest.mark.parametrize("d,hq,hkv,hd,f,s,a_i8", [
    (2048, 32, 4, 64, 5632, 2048, False),       # TinyLlama-1.1B: hd 64, n_rep 8
    (4096, 32, 32, 128, 11008, 2048, True),     # Llama-2-7B: hd 128, n_rep 1
    (8192, 64, 8, 128, 28672, 4096, True)],     # 70B: hd 128, n_rep 8, S 4096
    ids=["tinyllama", "7b", "70b"])
def test_k7_plans_over_the_f32_cache(d, hq, hkv, hd, f, s, a_i8):
    """K7's plans over the f32 cache, without and with phase E, are the bf16
    cache's at the TinyLlama-1.1B, Llama-2-7B and 70B shapes (phase B stages
    an f32 chunk's K, then its V, in the bf16 chunk's area), and plan at
    least one stage; the int8 cache's chunk area differs."""
    from zgml_tpu_torch.ops import decode_plan as dp
    for ffn in (0, f):
        plans = [dp.attn_plan(d, hq, hkv, hd, "q4_0", a_i8, kv, s, 132, f=ffn)
                 for kv in (dp.KV_BF16, dp.KV_F32)]
        assert plans[0] == plans[1] and plans[1].stages >= 1
    assert dp.decode_chunk_smem_bytes(hd, dp.KV_F32, hq // hkv) == \
        dp.decode_chunk_smem_bytes(hd, dp.KV_BF16, hq // hkv) != \
        dp.decode_chunk_smem_bytes(hd, dp.KV_INT8, hq // hkv)


# -- the engines ----------------------------------------------------------------------------

N_STEPS = 4


def _gap(logits) -> float:
    top2 = np.sort(logits)[-2:]
    return float(top2[1] - top2[0])


@pytest.fixture(scope="module", params=[GGMLType.Q4_0, GGMLType.Q8_0], ids=["q4_0", "q8_0"])
def gguf(request, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("f32_engine") / f"d512_{request.param.name}.gguf")
    write_synthetic_llama_gguf(path, CFG, quant=request.param, seed=11)
    return path


@pytest.mark.parametrize("batch", [1, 2])
def test_engine_f32_cache_matches_jax(flags, gguf, batch):
    """LlamaEngine(cache_dtype="f32") against JAX's LlamaEngine(cache_dtype=
    jnp.float32) on a 20-token prompt per row in one chunk of 64: the prefill
    logits, N_STEPS decode steps fed JAX's greedy tokens and the port's own
    greedy tokens; the port's prefill through K3's f32-K/V form, its decode
    through K7's f32-cache mode at batch 1 and K4's f32 form at batch 2. At
    batch 2 the JAX side keeps the per-layer f32 cache (ZGML_TPU_KV_STACK=0,
    the same function): its stacked cache's prefill asserts batch 1
    (zgml_tpu/ops/attention.py:223)."""
    prompt = np.random.default_rng(6).integers(0, CFG.vocab_size, (batch, 20))
    if batch > 1:   # JAX's stacked cache takes batch-1 prefill only (attention.py:223)
        flags.setenv("ZGML_TPU_KV_STACK", "0")
    jmodel, jgf = jax_load_llama(gguf)
    jgf.close()
    jeng = JaxEngine(jmodel, batch=batch, prefill_chunk=64, cache_dtype=jnp.float32,
                     donate_cache=False)
    jlogits = np.asarray(jeng.prefill(prompt))
    tok, feed, jstep = np.argmax(jlogits, -1).astype(np.int32), [], []
    for _ in range(N_STEPS):
        feed.append(tok)
        nxt, lg = jeng.step(tok)
        jstep.append(np.asarray(lg))
        tok = np.asarray(nxt)
    pmodel, pgf = load_llama(gguf, device="cpu")
    pgf.close()
    global_profile.reset()
    peng = LlamaEngine(pmodel, batch=batch, prefill_chunk=64, cache_dtype="f32")
    assert peng.cache["k"].dtype == torch.float32
    plogits = peng.prefill(prompt).numpy()
    pstep = [peng.step(torch.from_numpy(t.astype(np.int64)))[1].numpy() for t in feed]
    tiers = global_profile.tier_summary()
    _close(plogits, jlogits, 1e-3, "prefill")
    for got, want in zip(pstep, jstep):
        _close(got, want, I8_RTOL, "step")
    peng.reset()
    ptoks = peng.generate(prompt[0], N_STEPS) if batch == 1 else None
    if ptoks is not None:
        want_toks = [int(feed[i][0]) for i in range(1, N_STEPS)] + [int(tok[0])]
        gaps = [_gap(jlogits[0])] + [_gap(s[0]) for s in jstep]
        scales = [np.max(np.abs(jlogits[0]))] + [np.max(np.abs(s[0])) for s in jstep]
        n = next((i for i, (g, sc) in enumerate(zip(gaps, scales)) if g < I8_RTOL * sc), N_STEPS)
        assert ptoks[:n] == ([int(feed[0][0])] + want_toks)[:n]
    assert "attention_f32kv" in tiers
    decode = "attn_block_f32kv" if batch == 1 else "decode_attention_f32"
    assert tiers[decode + ("_q8" if batch == 1 and "q8_0" in gguf.lower() else "")]
    assert not {"attention", "attention_bf16", "decode_attention", "attn_block"} & set(tiers)


def test_server_f32_cache_matches_jax(tmp_path, flags):
    """ContinuousBatchingEngine(cache_dtype="f32") against JAX's server over
    an f32 cache on two requests (the second prefilled into slot 1, its
    chunk within the cache): equal greedy streams."""
    path = str(tmp_path / "t.gguf")
    write_synthetic_llama_gguf(path, TINY_TEST, GGMLType.Q8_0, seed=9)
    port, gf = load_llama(path, device="cpu", mode="dense")
    gf.close()
    jax_model, jgf = jax_load_llama(path, mode="dense")
    jgf.close()
    reqs = [([1, 2, 3], 4), ([4, 5], 4)]
    jouts = JaxServer(jax_model, max_batch=2, cache_dtype=jnp.float32).run(reqs)
    global_profile.reset()
    outs = ContinuousBatchingEngine(port, max_batch=2, cache_dtype="f32").run(reqs)
    assert [outs[r] for r in sorted(outs)] == [jouts[r] for r in sorted(jouts)]
    assert "decode_attention_f32" in global_profile.tier_summary()


@pytest.mark.parametrize("bf16", ["0", "1"], ids=["prefill_f32", "default"])
def test_gpt_engine_f32_cache_matches_jax(flags, bf16):
    """The GPT engine over an f32 cache (GPTModel.init_cache(b, "f32"))
    against the JAX engine with cache_dtype=jnp.float32: a 40-token prompt in
    chunks of 16 (the last padded), then 12 greedy tokens; prefill through
    K3's f32-K/V forms, decode through K4's f32 form."""
    flags.setenv("ZGML_TPU_PREFILL_BF16", bf16)
    cfg = GPTConfig(vocab_size=96, d_model=64, n_heads=4, n_layers=2, max_seq_len=64,
                    learned_pos=True)
    jcfg = jgpt.GPTConfig(**dataclasses.asdict(cfg))
    jm = jgpt.GPTModel(jcfg, jgpt.init_params(jcfg, seed=5, scale=0.5))
    tm = GPTModel(cfg, gpt_params_from_jax({k: v for k, v in _tree_np(jm.params).items()}, cfg,
                                           device="cpu"))
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, 40)
    want = JaxEngine(jm, prefill_chunk=16, cache_dtype=jnp.float32,
                     donate_cache=False).generate(prompt, 12)
    global_profile.reset()
    eng = LlamaEngine(tm, prefill_chunk=16, cache_dtype="f32")
    assert eng.cache["k"].dtype == torch.float32
    assert eng.generate(prompt, 12) == want
    tiers = global_profile.tier_summary()
    assert ("attention_bf16_f32kv" if bf16 == "1" else "attention_f32kv") in tiers
    assert "decode_attention_f32" in tiers


def _tree_np(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


def test_megacalls_refuse_the_f32_cache(flags, d512_q4):
    """The whole-stack megacall K14 refuses nothing the JAX package's takes:
    over the f32 cache the engine's decode steps under ZGML_TPU_STACK_DECODE
    run its f32-cache mode (stack_decode_f32kv, one a step, no K7) and give
    the per-layer path's logits (K7's f32-cache mode + K6d, the same
    function) within 3e-3 * max|logit| (tests/test_torch_stackkernel.py's
    bound). tests/test_torch_megacall_f32_cache.py holds K14 and K15 over the
    f32 cache to the JAX kernels."""
    model, gf = load_llama(d512_q4, device="cpu")
    gf.close()
    assert model.enable_stacked_decode()
    prompt = np.arange(8)

    def steps():
        eng = LlamaEngine(model, cache_dtype="f32", prefill_chunk=16)
        tok = torch.argmax(eng.prefill(prompt), dim=-1)
        out = []
        for _ in range(3):
            tok, lg = eng.step(tok)
            out.append(lg[0])
        return out
    per_layer = steps()
    flags.setenv("ZGML_TPU_STACK_DECODE", "1")
    global_profile.reset()
    mega = steps()
    tiers = global_profile.tier_summary()
    assert tiers["stack_decode_f32kv"] == {"ref": 3}
    assert not any(op.startswith("attn_block") for op in tiers)
    for a, b in zip(per_layer, mega):
        assert float((a - b).abs().max()) <= 3e-3 * float(a.abs().max())
