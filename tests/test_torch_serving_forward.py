"""Continuous batching's model paths against the JAX package, on the CPU:
`forward` with per-row positions (and write_pos) and with cache_row, the
per-row cache writes, the dense load mode, and the path serving takes.

Both packages load one synthetic TINY_TEST GGUF (Q4_0 and Q8_0) under the
same flags (monkeypatch around both: ZGML_TPU_SCALES=f16, the prefill's f32
operands, the int8 tiers off); the JAX cache is the per-layer list
(`init_cache(B, layout="unrolled")`, which cache_row and per-row pos need).
The scenario: rows 0, 1 and 2 prefilled through cache_row (one
zero-padded chunk of 8 at pos 0 each, prompts of 5, 8 and 7 tokens), then
one per-row decode step at pos [5, 11, 0] with row 2 inactive, as a slot
still mid-prefill: write_pos [5, 11, S - 1], as the server writes it.

  - bf16 cache: the projections on the f32 plain tier on both sides
    (ZGML_TPU_KERNELS_DISABLE=qmatmul), so logits agree within 1e-4 *
    max|logit| (f32 sums in another order) and the written cache rows are
    equal up to the bf16 rounding of such a sum (within one bf16 ulp: one
    element of 6,144 flips at Q4_0);
  - int8 cache: the JAX Pallas kernels in interpret mode (its ref tier of
    decode_attention_q8 is not K8's function) and the default K1 int8
    projections (every call has at most 32 rows on both sides), so the
    logits are held at the repo's whole-model int8 bound, 1e-2 *
    max|logit| (2.6e-7 measured), the cache's levels are equal and its f32
    scales within 1e-6 relative (amax / 127 of K / V whose f32 sums differ
    in their last bits: up to 6 ulps measured; kv_cache.cache_from_jax).
    The JAX int8 prefill into a row other than 0 attends over row 0 (a
    reference weak spot, ROADMAP.md), so there its oracle is one batch-3
    prefill at pos 0, which computes each row from its own row as the slot
    prefill does.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zgml_tpu.io.llama_loader import load_llama as jax_load_llama

from zgml_tpu_torch.io.gguf import GGMLType
from zgml_tpu_torch.io.llama_loader import load_llama
from zgml_tpu_torch.models.llama import LlamaConfig, write_kv
from zgml_tpu_torch.quant import kv_cache
from zgml_tpu_torch.runtime.engine import LlamaEngine
from zgml_tpu_torch.runtime.profile import global_profile
from zgml_tpu_torch.runtime.serving import ContinuousBatchingEngine
from zgml_tpu_torch.utils.synthetic import TINY_TEST, write_synthetic_llama_gguf

torch.set_num_threads(1)

FLAGS = {"ZGML_TPU_SCALES": "f16", "ZGML_TPU_PREFILL_BF16": "0", "ZGML_TPU_ATTN_I8A": "0",
         "ZGML_TPU_FFN_I8A": "0", "ZGML_TPU_ATTN_I8PV": "0"}
RTOL, I8_RTOL = 1e-4, 1e-2
B, CHUNK, LENS = 3, 8, (5, 8, 7)
KINDS = {"q4_0": GGMLType.Q4_0, "q8_0": GGMLType.Q8_0}


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_fwd")
    out = {}
    for kind, t in KINDS.items():
        out[kind] = str(d / f"{kind}.gguf")
        write_synthetic_llama_gguf(out[kind], TINY_TEST, t, seed=13)
    return out


def _jax_cache(cache, int8):
    """The JAX per-layer cache as the port's: bf16 [L, B, Hkv, S, hd] as f32
    numpy, or the int8 dict through cache_from_jax."""
    if int8:
        return {k: v.numpy() for k, v in kv_cache.cache_from_jax(
            {n: [tuple(np.asarray(a) for a in layer) for layer in cache[n]]
             for n in ("k", "v")}, device="cpu").items()}
    return {n: np.stack([np.asarray(c.astype(jnp.float32)) for c in cache[n]])
            for n in ("k", "v")}


def _scenario(path, cache_dtype, flags):
    """(port, jax) each as (prefill logits [row][n_valid, V], step logits
    [B, V], cache as numpy), and the step's tokens."""
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, TINY_TEST.vocab_size, n) for n in LENS]
    int8 = cache_dtype == "int8"
    with pytest.MonkeyPatch.context() as mp:
        for k, v in flags.items():
            mp.setenv(k, v)
        jmodel, jgf = jax_load_llama(path)
        jgf.close()
        jcache = jmodel.init_cache(B, "int8" if int8 else jnp.bfloat16, layout="unrolled")
        toks = np.zeros((B, CHUNK), np.int32)
        for row, p in enumerate(prompts):
            toks[row, :len(p)] = p
        if int8:
            lg, jcache = jmodel.forward(jmodel.params, jnp.asarray(toks), jcache, 0)
            jpre = [np.asarray(lg)[row, :len(p)] for row, p in enumerate(prompts)]
        else:
            jpre = []
            for row, p in enumerate(prompts):
                lg, jcache = jmodel.forward(jmodel.params, jnp.asarray(toks[row:row + 1]),
                                            jcache, 0, cache_row=row)
                jpre.append(np.asarray(lg)[0, :len(p)])
        tok = np.array([int(np.argmax(lg[-1])) for lg in jpre], np.int32)[:, None]
        pos = np.array([*LENS[:2], 0], np.int32)
        wpos = np.array([*LENS[:2], TINY_TEST.max_seq_len - 1], np.int32)
        lg, jcache = jmodel.forward(jmodel.params, jnp.asarray(tok), jcache, jnp.asarray(pos),
                                    write_pos=jnp.asarray(wpos))
        jax_out = (jpre, np.asarray(lg)[:, 0], _jax_cache(jcache, int8))

        pmodel, pgf = load_llama(path, device="cpu")
        pgf.close()
        cache = pmodel.init_cache(B, cache_dtype)
        ppre = []
        for row, p in enumerate(prompts):
            toks = torch.zeros((1, CHUNK), dtype=torch.int64)
            toks[0, :len(p)] = torch.from_numpy(p)
            ppre.append(pmodel(toks, cache, 0, cache_row=row)[0, :len(p)].numpy())
        lg = pmodel(torch.from_numpy(tok).long(), cache, torch.from_numpy(pos),
                    write_pos=torch.from_numpy(wpos))
        port_out = (ppre, lg[:, 0].numpy(), {k: v.float().numpy() for k, v in cache.items()})
    return port_out, jax_out


def _close(got, want, rtol):
    assert np.max(np.abs(got - want)) <= rtol * np.max(np.abs(want))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_cache_row_and_per_row_pos_match_jax_bf16_cache(paths, kind):
    flags = {**FLAGS, "ZGML_TPU_KERNELS_DISABLE": "qmatmul"}
    (ppre, pstep, pcache), (jpre, jstep, jcache) = _scenario(paths[kind], "bf16", flags)
    for a, b in zip(ppre, jpre):
        _close(a, b, RTOL)
    _close(pstep, jstep, RTOL)
    for n in ("k", "v"):
        want = torch.from_numpy(jcache[n])
        _, e = torch.frexp(torch.where(want != 0, want.abs(), torch.ones_like(want)))
        ulp = torch.ldexp(torch.ones_like(want), e - 8)        # bf16 spacing at |want|
        assert bool(((torch.from_numpy(pcache[n]) - want).abs() <= ulp).all())
        assert np.mean(pcache[n] != jcache[n]) <= 1e-3


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_cache_row_and_per_row_pos_match_jax_int8_cache(paths, kind):
    (ppre, pstep, pcache), (jpre, jstep, jcache) = _scenario(paths[kind], "int8", FLAGS)
    for a, b in zip(ppre, jpre):
        _close(a, b, I8_RTOL)
    _close(pstep, jstep, I8_RTOL)
    for n in ("k", "v"):
        assert np.array_equal(pcache[n], jcache[n]), n
        got, want = pcache[f"{n}_s"], jcache[f"{n}_s"]
        assert np.all(np.abs(got - want) <= 1e-6 * np.abs(want)), n


# -- the per-row writes ------------------------------------------------------------

def test_per_row_write_lands_each_row_at_its_position():
    """write_kv (bf16) and kv_cache.write (int8) with wp: row b at wp[b] of
    layer li, nothing else; a write at the dead position S - 1 leaves a live
    prefix [0, 9) untouched."""
    L, b, hkv, s, hd = 2, 3, 2, 16, 8
    g = torch.Generator().manual_seed(1)
    k, v = (torch.randn((b, hkv, 1, hd), generator=g) for _ in range(2))
    wp = torch.tensor([4, 0, s - 1], dtype=torch.int32)
    ck = torch.randn((L, b, hkv, s, hd), generator=g).to(torch.bfloat16)
    cv = torch.randn((L, b, hkv, s, hd), generator=g).to(torch.bfloat16)
    before = (ck.clone(), cv.clone())
    write_kv(ck, cv, 1, 0, k, v, wp=wp)
    q = kv_cache.init_cache(L, b, hkv, s, hd, "cpu")
    q_before = {n: t.clone() for n, t in q.items()}
    kv_cache.write((q["k"], q["k_s"]), (q["v"], q["v_s"]), 1, 0, k, v, wp=wp)
    lv, sc = kv_cache.quantize_columns(k)
    for row in range(b):
        at = int(wp[row])
        assert torch.equal(ck[1, row, :, at], k[row, :, 0].to(torch.bfloat16))
        assert torch.equal(cv[1, row, :, at], v[row, :, 0].to(torch.bfloat16))
        assert torch.equal(q["k"][1, row, :, at], lv[row, :, 0])
        assert torch.equal(q["k_s"][1, row, :, at], sc[row, :, 0])
    mask = torch.zeros((L, b, s), dtype=torch.bool)
    mask[1, torch.arange(b), wp.long()] = True
    for c, c0 in zip((ck, cv, q["k"], q["v"]), (*before, q_before["k"], q_before["v"])):
        assert torch.equal(c.transpose(2, 3)[~mask], c0.transpose(2, 3)[~mask])
    assert torch.equal(ck[:, 2, :, :9], before[0][:, 2, :, :9])


def test_dead_slot_decode_keeps_a_mid_prefill_prefix(paths):
    """A server step while a slot is mid-prefill (its chunk written, its
    prompt not done) writes that slot's decode K/V at the dead position only:
    the prefilled prefix is bit-unchanged after the step."""
    model, gf = load_llama(paths["q4_0"], device="cpu")
    gf.close()
    serve = ContinuousBatchingEngine(model, max_batch=2, prefill_chunk=4)
    serve.submit([1, 2, 3], 8)
    serve.step()                                     # r0 prefilled and decoding
    serve.submit(list(range(1, 11)), 2)              # 10 tokens: 3 chunks into slot 1
    serve.step()                                     # its first chunk, and a decode step
    prefix = serve.cache["k"][:, 1, :, :4].clone()
    serve.step()                                     # chunk 2 and a decode step with slot 1 dead
    assert torch.equal(serve.cache["k"][:, 1, :, :4], prefix)


# -- the dense load mode -----------------------------------------------------------

@pytest.mark.parametrize("quant", [GGMLType.Q4_0, GGMLType.Q8_0, GGMLType.F16])
def test_dense_load_is_jax_dense_load_bit_for_bit(tmp_path, quant):
    """load_llama(mode="dense") gives every weight as the JAX dense load
    does: f32 K-major [K, N], fused wqkv / w_gate_up concatenated along N,
    the same bits."""
    path = str(tmp_path / "m.gguf")
    write_synthetic_llama_gguf(path, TINY_TEST, quant, seed=2)
    pm, pgf = load_llama(path, device="cpu", mode="dense")
    pgf.close()
    jm, jgf = jax_load_llama(path, mode="dense")
    jgf.close()
    assert pm.cfg == LlamaConfig(**dataclasses.asdict(jm.cfg))
    for name in ("tok_embd", "out_norm", "lm_head"):
        assert np.array_equal(pm.params[name].numpy(), np.asarray(jm.params[name]))
    for pl, jl in zip(pm.params["layers"], jm.params["layers"]):
        for name in ("attn_norm", "ffn_norm", "wqkv", "wo", "w_gate_up", "w_down"):
            assert pl[name].dtype == torch.float32
            assert np.array_equal(pl[name].numpy(), np.asarray(jl[name])), name
    with pytest.raises(ValueError, match="load mode"):
        load_llama(path, device="cpu", mode="f16")


# -- the path serving takes --------------------------------------------------------

def test_serving_never_takes_k7_or_the_megacalls(tmp_path, monkeypatch):
    """On a model whose batch-1 decode runs K7 and, under
    ZGML_TPU_STACK_DECODE=1, K14 (d 512, hd 64, Q4_0), the server at one slot
    and at two runs `_layer_step` alone: K4 decode attention, K3 prefill
    into the slot, no attn_block or stack_decode count."""
    cfg = LlamaConfig(vocab_size=96, d_model=512, n_heads=8, n_kv_heads=2, d_ff=1024,
                      n_layers=2, max_seq_len=64)
    path = str(tmp_path / "d512.gguf")
    write_synthetic_llama_gguf(path, cfg, seed=7)
    for k, v in FLAGS.items():
        monkeypatch.setenv(k, v)
    model, gf = load_llama(path, device="cpu")
    gf.close()
    global_profile.reset()
    LlamaEngine(model).generate([1, 2, 3], 3)
    assert "attn_block" in global_profile.tier_summary()    # batch 1 takes K7
    assert model.enable_stacked_decode()
    monkeypatch.setenv("ZGML_TPU_STACK_DECODE", "1")
    for max_batch in (1, 2):
        global_profile.reset()
        ContinuousBatchingEngine(model, max_batch=max_batch).run([([1, 2, 3], 3), ([4], 2)])
        tiers = global_profile.tier_summary()
        assert "attn_block" not in tiers and "stack_decode" not in tiers, tiers
        assert "decode_attention" in tiers and "attention" in tiers
