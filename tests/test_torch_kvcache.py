"""The int8 KV cache: the port against the JAX package on the CPU.

The JAX side runs its Pallas kernels in interpret mode (tests/conftest.py),
not its ref tier: the ref tier of `decode_attention_q8` dequantizes the cache
and attends with an unquantized q, which is not K8's function (K8 quantizes q
per query head first; test_plain_k8_is_the_kernels_function_not_the_ref_tier
shows the gap). Flags on both sides: ZGML_TPU_SCALES=f16,
ZGML_TPU_PREFILL_BF16=0 (K9's f32 operands, the port's standing prefill),
ZGML_TPU_ATTN_I8A / ZGML_TPU_FFN_I8A set explicitly, ZGML_TPU_ATTN_I8PV=0.

Tolerances: the cache quantization is bit-equal to JAX's; the plain K8, K9
and K7-kv8 against the JAX kernels on shared int8 caches within 1e-5 *
max|out| (f32 sums in another order; the integer q.k dots are exact on both
sides); the whole slice at the d 512 / 8-2 heads / 2-layer config within the
int8 tier's flip-aware 1e-2 * max|logit| (ROADMAP C: a 1e-7 perturbation
moves such a model by up to 7.5e-3), and one decode step from a cache
carried over from JAX (cache_from_jax) within 1e-5 * max|logit|.

K8's ZGML_TPU_ATTN_I8PV mode (p * v_scale quantized to int8 per JAX block,
`decode_attention_q8_pallas(pq_i8=True)`) is held to 1e-5 * max|out| too:
both sides round the same f32 values (the integer P.V is exact on both), and
where exp of the two CPU libraries put p * v_scale / psc on the two sides
of a half a level would flip; none does on these inputs (measured <= 2e-7
of max|out|). Its plain version must leave the f32-p function, and p
quantized per 32 keys, by at least 10x that tolerance, so neither shortcut
passes. Its slice run (the flag set before JAX first traces the forward)
holds the int8 tier's bounds above; and again at the JAX default
ZGML_TPU_PREFILL_BF16 (K2's and K9's bf16 forms write the int8 cache),
where the bounds are flip-aware: each the larger of 1e-2 * max|logit| and
2 x the port's own move under 1e-7 perturbations of the embedding (there
the bf16 K and V cross int8 rounding edges: the port's steps move by up to
1.1e-2 of max|logit| under them, and sit 1.09e-2 from JAX's).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zgml_tpu.io.llama_loader import load_llama as jax_load_llama
from zgml_tpu.models.llama import LlamaConfig as JaxConfig
from zgml_tpu.ops import attention as jattn
from zgml_tpu.ops import dispatch as jops
from zgml_tpu.ops import refs as jrefs
from zgml_tpu.ops.attention import decode_attention_q8_pallas, flash_attention_q8_pallas
from zgml_tpu.ops.layerkernel import attn_block_step
from zgml_tpu.quant import kv_cache as jkv
from zgml_tpu.runtime.engine import LlamaEngine as JaxEngine

from zgml_tpu_torch.io.llama_loader import load_llama
from zgml_tpu_torch.models.llama import LlamaConfig
from zgml_tpu_torch.ops import attention, dispatch, refs
from zgml_tpu_torch.quant import kv_cache, packed
from zgml_tpu_torch.runtime.engine import LlamaEngine
from zgml_tpu_torch.runtime.profile import global_profile
from zgml_tpu_torch.utils.synthetic import write_synthetic_llama_gguf

torch.set_num_threads(1)

FLAGS = {"ZGML_TPU_SCALES": "f16", "ZGML_TPU_PREFILL_BF16": "0", "ZGML_TPU_ATTN_I8A": "0",
         "ZGML_TPU_FFN_I8A": "0", "ZGML_TPU_ATTN_I8PV": "0"}
RTOL = 1e-5                # kernel functions on shared inputs
I8_RTOL = 1e-2             # whole-model int8 tier (ROADMAP C)
SENS_MARGIN = 2.0          # x the port's own move, where a bound is flip-aware
KV8_CFG = LlamaConfig(vocab_size=96, d_model=512, n_heads=8, n_kv_heads=2, d_ff=1024,
                      n_layers=2, max_seq_len=256)
PROMPT_LEN, N_STEPS = 20, 4


@pytest.fixture
def flags(monkeypatch):
    for k, v in FLAGS.items():
        monkeypatch.setenv(k, v)
    return monkeypatch


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    err, bound = np.max(np.abs(got - want)), rtol * np.max(np.abs(want))
    assert err <= bound, (err, bound)


def _jax_columns(x):
    """x f32 [B, H, S, d] -> the JAX int8 columns (k_q [B, H, d, S], k_s) and
    the port's position-major (levels, scales) of the same values."""
    q, s = jkv.quantize_columns(jnp.asarray(x))
    port = (torch.from_numpy(np.array(np.asarray(q).swapaxes(-1, -2), order="C")),
            torch.from_numpy(np.array(s)))
    return (q, s), port


@pytest.mark.parametrize("shape", [(2, 3, 5, 64), (1, 4, 7, 128), (2, 2, 3, 32)])
def test_quantize_columns_matches_jax_bit_for_bit(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    x[0, 0, 1] = 0.0                        # a zero row: scale 0, levels 0
    x[-1, -1, 0] *= 1e-30                   # a tiny one
    jq, js = jkv.quantize_columns(jnp.asarray(x))
    q, s = kv_cache.quantize_columns(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(jq).swapaxes(-1, -2))
    assert np.array_equal(s.numpy().view(np.uint32), np.asarray(js).view(np.uint32))
    assert float(s[0, 0, 1]) == 0.0 and not q[0, 0, 1].any()


def test_cache_from_jax_round_trip():
    """cache_from_jax turns the JAX int8 cache (its per-layer list) into the
    port's layout: the same levels and scales, and dequantized values
    bit-equal to the JAX dequantize_cache."""
    n_layers, b, hkv, s, hd = 2, 2, 2, 16, 32
    rng = np.random.default_rng(7)
    jc = jkv.init_quant_cache(n_layers, b, hkv, s, hd)
    jax_cache = {"k": [], "v": []}
    for name in ("k", "v"):
        for li in range(n_layers):
            x = rng.standard_normal((b, hkv, 5, hd)).astype(np.float32)
            q, sc = jkv.quantize_columns(jnp.asarray(x))
            jax_cache[name].append(jkv.write_columns(jc[f"{name}_q"][li], jc[f"{name}_s"][li],
                                                     q, sc, 3 + li))
    port = kv_cache.cache_from_jax(jax_cache, device="cpu")
    assert set(port) == {"k", "k_s", "v", "v_s"}
    assert port["k"].shape == (n_layers, b, hkv, s, hd) and port["k"].dtype == torch.int8
    assert port["k_s"].shape == (n_layers, b, hkv, s) and port["k_s"].dtype == torch.float32
    for name in ("k", "v"):
        for li, (q, sc) in enumerate(jax_cache[name]):
            assert np.array_equal(port[name][li].numpy().swapaxes(-1, -2), np.asarray(q))
            assert np.array_equal(port[f"{name}_s"][li].numpy(), np.asarray(sc))
            want = np.asarray(jkv.dequantize_cache(q, sc))
            got = kv_cache.dequantize(port[name][li], port[f"{name}_s"][li]).numpy()
            assert np.array_equal(got, want)


def _q8_inputs(seed, b, hq, hkv, tq, rows, s, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, tq, d)).astype(np.float32)
    jk, pk = _jax_columns(rng.standard_normal((rows, hkv, s, d)).astype(np.float32))
    jv, pv = _jax_columns(rng.standard_normal((rows, hkv, s, d)).astype(np.float32))
    return q, jk, jv, pk, pv


DECODE_CASES = [
    # b, hq, hkv, rows, s, d, kv_len, kv_row: several 256-position blocks, per-row kv_len
    (2, 8, 2, 2, 512, 64, [300, 512], 0),      # GQA
    (2, 4, 4, 2, 768, 64, [1, 700], 0),        # MHA
    (2, 8, 2, 3, 256, 32, [0, 129], 1),        # kv_row > 0; a row with no live key
    (1, 4, 4, 1, 384, 128, [333], 0),          # head_dim 128; blocks of 128 (384 % 256)
    (2, 8, 2, 2, 200, 64, [200, 77], 0),       # S 200: one block of 200
    (2, 4, 2, 3, 300, 32, [300, 129], 1),      # S 300: blocks of 128, the cache padded
]


@pytest.mark.parametrize("b,hq,hkv,rows,s,d,kv_len,kv_row", DECODE_CASES)
def test_decode_q8_plain_matches_jax_kernel(flags, b, hq, hkv, rows, s, d, kv_len, kv_row):
    q, (kq, ks), (vq, vs), pk, pv = _q8_inputs(s + d + b, b, hq, hkv, 1, rows, s, d)
    sl = slice(kv_row, kv_row + b)
    lens = np.asarray(kv_len, np.int32)
    want = np.asarray(decode_attention_q8_pallas(jnp.asarray(q), kq[sl], ks[sl], vq[sl], vs[sl],
                                                 jnp.asarray(lens)))
    global_profile.reset()
    got = dispatch.decode_attention_q8(torch.from_numpy(q), *pk, *pv, torch.from_numpy(lens),
                                       kv_row=kv_row)
    assert global_profile.tier_summary() == {"decode_attention_q8": {"ref": 1}}
    _close(got.numpy(), want)


def _q8_case(b, hq, hkv, rows, s, d, kv_len, kv_row):
    """The inputs of a DECODE_CASES entry: (q, JAX K / V columns of the
    query rows, the port's (levels, scales) of K and V, lens)."""
    q, (kq, ks), (vq, vs), pk, pv = _q8_inputs(s + d + b, b, hq, hkv, 1, rows, s, d)
    sl = slice(kv_row, kv_row + b)
    return q, (kq[sl], ks[sl], vq[sl], vs[sl]), (*pk, *pv), np.asarray(kv_len, np.int32)


@pytest.mark.parametrize("b,hq,hkv,rows,s,d,kv_len,kv_row", DECODE_CASES)
def test_decode_q8_i8pv_plain_matches_jax_kernel(flags, b, hq, hkv, rows, s, d, kv_len, kv_row):
    """ZGML_TPU_ATTN_I8PV=1: the port's plain K8 in its int8 P.V mode (through
    the dispatch, counted under decode_attention_q8_i8pv) against the JAX
    Pallas kernel at pq_i8=True, per JAX block of k8_block(S) keys."""
    flags.setenv("ZGML_TPU_ATTN_I8PV", "1")
    q, jcols, pcols, lens = _q8_case(b, hq, hkv, rows, s, d, kv_len, kv_row)
    want = np.asarray(decode_attention_q8_pallas(jnp.asarray(q), *jcols, jnp.asarray(lens),
                                                 pq_i8=True))
    global_profile.reset()
    got = dispatch.decode_attention_q8(torch.from_numpy(q), *pcols, torch.from_numpy(lens),
                                       kv_row=kv_row)
    assert global_profile.tier_summary() == {"decode_attention_q8_i8pv": {"ref": 1}}
    _close(got.numpy(), want)
    for row, n in enumerate(kv_len):
        if n == 0:
            assert not got[row].any()


def _i8pv_gap(case, **other):
    """max|I8PV - other| / max|I8PV| of the plain K8 on a DECODE_CASES entry,
    `other` the plain version's keywords of the function compared with."""
    b, hq, hkv, rows, s, d, kv_len, kv_row = case
    q, _, pcols, lens = _q8_case(*case)
    args = (torch.from_numpy(q), *pcols, torch.from_numpy(lens), kv_row)
    i8pv = attention.decode_attention_q8_ref(*args, i8pv=True).numpy()
    return np.abs(i8pv - attention.decode_attention_q8_ref(*args, **other).numpy()).max() / (
        np.abs(i8pv).max())


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_q8_i8pv_is_not_the_f32p_function(case):
    """The I8PV plain version leaves the f32-p function (p * v_scale in f32)
    by at least 10x the 1e-5 tolerance it meets against JAX."""
    assert _i8pv_gap(case, i8pv=False) >= 10 * RTOL


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_q8_i8pv_is_not_p_quantized_per_32_keys(case):
    """The same margin against p quantized per 32 keys (a warp's group):
    the quantization group is the whole JAX block (256, 128, or S keys)."""
    assert _i8pv_gap(case, i8pv=True, block=32) >= 10 * RTOL


def _jax_block_rule(s: int, bs: int = 256) -> int:
    """zgml_tpu/ops/attention.py:536-545, bs_eff of decode_attention_q8_pallas."""
    bs_eff = min(bs, s)
    while bs_eff >= 256 and s % bs_eff:
        bs_eff //= 2
    if s % bs_eff:
        bs_eff = min(bs, 128)
    return bs_eff


def test_k8_block_follows_jax(monkeypatch):
    """attention.k8_block(S) is the JAX kernel's block for every S in 1..2100
    (the rule of attention.py:536-545), and at a few S the block the JAX
    wrapper itself hands its kernel (the kernel stubbed out): 256 at 2048,
    128 at 300 (the cache padded to 384) and 384, S below 256."""
    assert all(attention.k8_block(s) == _jax_block_rule(s) for s in range(1, 2101))
    assert (attention.k8_block(2048), attention.k8_block(300), attention.k8_block(384),
            attention.k8_block(200)) == (256, 128, 128, 200)
    seen = {}

    def stub(qq, qs, kq, ks, vq, vs, kv_len, *, hkv, bs, scale, pq_i8, dyn=True):
        seen[kq.shape[-1]] = bs
        return jnp.zeros(qq.shape, jnp.float32)
    monkeypatch.setattr(jattn, "_decode_q8", stub)
    q = jnp.zeros((1, 1, 1, 16))
    for s in (1, 64, 200, 256, 300, 384, 1000, 2048, 2100):
        seen.clear()
        z, sc = jnp.zeros((1, 1, 16, s), jnp.int8), jnp.zeros((1, 1, s))
        decode_attention_q8_pallas(q, z, sc, z, sc, 1, pq_i8=True)
        (padded, bs), = seen.items()
        assert bs == attention.k8_block(s) and padded == -(-s // bs) * bs, (s, seen)


def test_plain_k8_is_the_kernels_function_not_the_ref_tier(flags):
    """The JAX ref tier of decode_attention_q8 (dequantize, then attend with
    an unquantized q) is another function than its kernel K8 by far more
    than the tolerance; the port's plain K8 is the kernel's."""
    q, (kq, ks), (vq, vs), pk, pv = _q8_inputs(2, 2, 32, 4, 1, 2, 256, 64)
    kernel = np.asarray(decode_attention_q8_pallas(jnp.asarray(q), kq, ks, vq, vs, 200))
    with jops.force_ref():
        ref_tier = np.asarray(jops.decode_attention_q8(jnp.asarray(q), kq, ks, vq, vs, 200))
    port = dispatch.decode_attention_q8(torch.from_numpy(q), *pk, *pv, 200).numpy()
    scale = np.max(np.abs(kernel))
    assert np.max(np.abs(ref_tier - kernel)) > 100 * RTOL * scale
    _close(port, kernel)


FLASH_CASES = [
    # b, hq, hkv, tq, rows, s, d, kv_len, q_offset, kv_row
    (1, 8, 2, 16, 1, 128, 64, 16, 0, None),        # GQA, first chunk
    (1, 8, 2, 16, 3, 256, 64, 40, 24, 2),          # kv_row (stacked-cache layer 2)
    (2, 4, 4, 24, 2, 128, 32, 64, 40, None),       # batch 2, q_offset, kv_len < end
    (1, 4, 4, 16, 1, 384, 128, 300, 284, None),    # head_dim 128, several blocks
]


@pytest.mark.parametrize("b,hq,hkv,tq,rows,s,d,kv_len,q_off,kv_row", FLASH_CASES)
def test_flash_q8_plain_matches_jax_kernel(flags, b, hq, hkv, tq, rows, s, d, kv_len, q_off,
                                           kv_row):
    q, (kq, ks), (vq, vs), pk, pv = _q8_inputs(s + tq + kv_len, b, hq, hkv, tq, rows, s, d)
    want = np.asarray(flash_attention_q8_pallas(jnp.asarray(q), kq, ks, vq, vs, kv_len=kv_len,
                                                q_offset=q_off, kv_row=kv_row))
    global_profile.reset()
    got = dispatch.flash_attention_q8(torch.from_numpy(q), *pk, *pv, kv_len=kv_len,
                                      q_offset=q_off, kv_row=kv_row or 0)
    assert global_profile.tier_summary() == {"flash_attention_q8": {"ref": 1}}
    _close(got.numpy(), want)


def _attn_layer(rng, hq, hkv, hd, kind):
    from zgml_tpu.quant.headmajor import attach_head_major
    from zgml_tpu.quant.repack import concat_packed, quantize_weight
    d = hq * hd

    def qw(n, k, **kw):
        return quantize_weight(rng.standard_normal((n, k)).astype(np.float32) * 0.08, kind, **kw)
    layer = {"wqkv": concat_packed([qw(hq * hd, d, n_align=1), qw(hkv * hd, d, n_align=1),
                                    qw(hkv * hd, d, n_align=1)]),
             "wo": qw(d, hq * hd),
             "attn_norm": (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)}
    assert attach_head_major(layer, hq, hkv, hd)
    return layer


@pytest.mark.parametrize("pos,hq,hkv,hd,kind,a_i8", [
    (0, 8, 2, 32, "q4_0", False), (37, 8, 2, 32, "q4_0", False), (37, 4, 2, 64, "q8_0", False),
    (130, 8, 2, 32, "q4_0", True), (37, 4, 4, 128, "q4_0", True), (37, 4, 4, 128, "q8_0", True)])
def test_attn_block_kv8_plain_matches_jax_kernel(flags, pos, hq, hkv, hd, kind, a_i8):
    """K7's int8-cache mode (`kv_i8`) against JAX `attn_block_step` on a
    tuple cache, at both A phases (ZGML_TPU_ATTN_I8A on both sides) and both
    kinds: x_out, k_cur, v_cur within 1e-5 * max|out|; the port writes row
    pos of layer li as quantize_columns(k_cur / v_cur) and nothing else."""
    flags.setenv("ZGML_TPU_ATTN_I8A", "1" if a_i8 else "0")
    rng = np.random.default_rng(200 + pos + hd)
    s, n_layers, li = 256, 2, 1
    cfg = JaxConfig(vocab_size=128, d_model=hq * hd, n_heads=hq, n_kv_heads=hkv, d_ff=128,
                    n_layers=n_layers, max_seq_len=s)
    layer = _attn_layer(rng, hq, hkv, hd, kind)
    x = rng.standard_normal((1, 1, cfg.d_model)).astype(np.float32)
    cache = {}
    for name in ("k", "v"):
        _, (lv, sc) = _jax_columns(rng.standard_normal((n_layers, hkv, s, hd)).astype(np.float32))
        cache[name], cache[f"{name}_s"] = lv[:, None].contiguous(), sc[:, None].contiguous()
    jcache = {name: (jnp.asarray(cache[name][li].numpy().swapaxes(-1, -2)),
                     jnp.asarray(cache[f"{name}_s"][li].numpy())) for name in ("k", "v")}
    cos, sin = jrefs.rope_cos_sin(jnp.asarray([pos]), hd, cfg.rope_base)
    jx, jk, jv, did_ffn, _, _ = attn_block_step(
        cfg, layer, jnp.asarray(x), jcache["k"], jcache["v"], pos,
        jnp.concatenate([cos, cos], axis=1), jnp.concatenate([-sin, sin], axis=1))
    assert not did_ffn

    port = packed.from_planar_q8_0 if kind == "q8_0" else packed.from_planar_q4_0
    wqkv, wo = layer["wqkv"], layer["wo"]
    before = {k: v.clone() for k, v in cache.items()}
    pcos, psin = refs.rope_cos_sin(torch.tensor([pos]), hd, cfg.rope_base)
    global_profile.reset()
    xo, kc, vc = dispatch.attn_block(
        torch.from_numpy(x), torch.from_numpy(layer["attn_norm"]),
        port(wqkv.qvals, wqkv.scales, wqkv.n, wqkv.k, device="cpu"),
        port(wo.qvals, wo.scales, wo.n, wo.k, device="cpu"),
        (cache["k"], cache["k_s"]), (cache["v"], cache["v_s"]), li,
        torch.tensor([pos], dtype=torch.int32), pcos, psin, hq, hkv, cfg.rms_norm_eps)
    name = "attn_block" + ("_i8" if a_i8 else "") + "_kv8" + ("_q8" if kind == "q8_0" else "")
    assert global_profile.tier_summary() == {name: {"ref": 1}}
    for got, want in ((xo, jx), (kc, jk), (vc, jv)):
        _close(got.numpy(), want)
    rows = torch.arange(s) != pos
    for name, cur in (("k", kc), ("v", vc)):
        q, sc = kv_cache.quantize_columns(cur[0, :, 0])
        assert torch.equal(cache[name][li, 0, :, pos], q)
        assert torch.equal(cache[f"{name}_s"][li, 0, :, pos], sc)
        assert torch.equal(cache[name][:, :, :, rows], before[name][:, :, :, rows])
        assert torch.equal(cache[f"{name}_s"][:, :, :, rows], before[f"{name}_s"][:, :, :, rows])


@pytest.fixture(scope="module")
def kv8_model(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_kv8") / "d512_q4.gguf")
    # seed 24: on seed 21 a 1e-7 perturbation of the port's own embeddings
    # moved a batch-2 step by 5.6e-4 * max|logit| (one q or k level flipped by
    # the quantization before K8), which is what the carried-cache step then
    # differed by, and its chunk-16 prefill by up to 7e-3 (1.27e-2 from JAX)
    write_synthetic_llama_gguf(path, KV8_CFG, seed=24)
    return path


def _gap(logits) -> float:
    top2 = np.sort(logits)[-2:]
    return float(top2[1] - top2[0])


def _slice_run(path, batch, chunk, cfg=KV8_CFG, prompt_len=PROMPT_LEN, flags=FLAGS):
    """JAX LlamaEngine(cache_dtype="int8") and the port's on one prompt per
    row, under `flags` on both sides (set before JAX traces the forward):
    the prefill logits, the JAX cache after it, then N_STEPS greedy steps on
    the JAX side and the port fed the same tokens; the port also steps once
    from the JAX cache carried over by cache_from_jax."""
    prompt = np.random.default_rng(9).integers(0, cfg.vocab_size, (batch, prompt_len))
    with pytest.MonkeyPatch.context() as mp:
        for k, v in flags.items():
            mp.setenv(k, v)
        jmodel, jgf = jax_load_llama(path)
        jgf.close()
        jeng = JaxEngine(jmodel, batch=batch, prefill_chunk=chunk, cache_dtype="int8",
                         donate_cache=False)
        jlogits = np.asarray(jeng.prefill(prompt))
        jcache = {k: [tuple(np.asarray(a) for a in layer) for layer in v]
                  for k, v in jeng.cache.items()}
        tok, feed, jstep = np.argmax(jlogits, -1).astype(np.int32), [], []
        for _ in range(N_STEPS):
            feed.append(tok)
            nxt, lg = jeng.step(tok)
            jstep.append(np.asarray(lg))
            tok = np.asarray(nxt)

        pmodel, pgf = load_llama(path, device="cpu")
        pgf.close()
        global_profile.reset()
        peng = LlamaEngine(pmodel, batch=batch, prefill_chunk=chunk, cache_dtype="int8")
        plogits = peng.prefill(prompt).numpy()
        pstep = [peng.step(torch.from_numpy(t.astype(np.int64)))[1].numpy() for t in feed]
        tiers = global_profile.tier_summary()
        peng.reset()
        peng.prefill(prompt)
        for k, v in kv_cache.cache_from_jax(jcache, device="cpu").items():
            peng.cache[k].copy_(v)
        carried = peng.step(torch.from_numpy(feed[0].astype(np.int64)))[1].numpy()
    return dict(jax=(jlogits, jstep), port=(plogits, pstep), carried=carried, tiers=tiers,
                prompt=prompt, feed=feed)


def _port_moves(path, batch, chunk, prompt, feed, flags, draws=4, eps=1e-7):
    """How far the port's own prefill logits and decode steps (fed `feed`)
    move, relative to their max|logit|, when tok_embd is scaled by (1 + eps
    N(0, 1)), the largest over `draws` seeded draws: (prefill, steps)."""
    def run(model):
        eng = LlamaEngine(model, batch=batch, prefill_chunk=chunk, cache_dtype="int8")
        return [eng.prefill(prompt).numpy()] + [
            eng.step(torch.from_numpy(t.astype(np.int64)))[1].numpy() for t in feed]

    def rel(a, b):
        return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))
    with pytest.MonkeyPatch.context() as mp:
        for k, v in flags.items():
            mp.setenv(k, v)
        model, gf = load_llama(path, device="cpu")
        gf.close()
        base, emb = run(model), model.params["tok_embd"].clone()
        g, moves = torch.Generator().manual_seed(0), [0.0, 0.0]
        for _ in range(draws):
            model.params["tok_embd"].copy_(emb * (1 + eps * torch.randn(emb.shape, generator=g)))
            out = run(model)
            moves = [max(moves[0], rel(out[0], base[0])),
                     max([moves[1]] + [rel(a, b) for a, b in zip(out[1:], base[1:])])]
    return moves


@pytest.fixture(scope="module", params=[(1, 16), (2, 16), (1, 128), (2, 128)],
                ids=["b1-chunk16", "b2-chunk16", "b1-chunk128", "b2-chunk128"])
def kv8_runs(request, kv8_model):
    return request.param, _slice_run(kv8_model, *request.param)


def test_kv8_prefill_logits_match_jax(kv8_runs):
    """Prefill through K9 (and K1 / K6b at chunk 16, K2 / K3-free at 128)
    over the int8 cache: within the flip-aware 1e-2 * max|logit|."""
    _, runs = kv8_runs
    _close(runs["port"][0], runs["jax"][0], I8_RTOL)


def test_kv8_steps_and_greedy_tokens_match_jax(kv8_runs):
    """N_STEPS decode steps fed JAX's greedy tokens (batch 1: K7-kv8; batch
    2: K8): each step's logits within 1e-2 * max|logit|, and the port's own
    greedy tokens equal to JAX's up to the first step whose JAX top-2 gap is
    under that bound."""
    _, runs = kv8_runs
    _steps_and_tokens_match(runs)


def _steps_and_tokens_match(runs, rtol=I8_RTOL):
    jstep, pstep = runs["jax"][1], runs["port"][1]
    for got, want in zip(pstep, jstep):
        _close(got, want, rtol)
    for row in range(jstep[0].shape[0]):
        for got, want in zip(pstep, jstep):
            if _gap(want[row]) < rtol * np.max(np.abs(want[row])):
                break
            assert np.argmax(got[row]) == np.argmax(want[row])


def test_kv8_step_from_carried_cache_matches_jax(kv8_runs):
    """One decode step from the JAX int8 cache carried over by
    cache_from_jax: the inputs are then the same on both sides, and the
    logits agree within 1e-5 * max|logit| (f32 A tier)."""
    _, runs = kv8_runs
    _close(runs["carried"], runs["jax"][1][0])


def test_kv8_run_takes_the_int8_cache_kernels(kv8_runs):
    """Placement: prefill through K9, batch-1 decode through K7's int8-cache
    mode, batch-2 decode through K8; no bf16-cache kernel."""
    (batch, chunk), runs = kv8_runs
    tiers = runs["tiers"]
    n_chunks, n_layers = -(-PROMPT_LEN // chunk), KV8_CFG.n_layers
    assert tiers["flash_attention_q8"] == {"ref": n_chunks * n_layers}
    decode = "attn_block_kv8" if batch == 1 else "decode_attention_q8"
    assert tiers[decode] == {"ref": N_STEPS * n_layers}
    assert not set(tiers) & {"attention", "decode_attention", "attn_block",
                             "attn_block_kv8" if batch > 1 else "decode_attention_q8"}, tiers


def test_init_cache_refuses_other_dtypes(kv8_model):
    """A cache dtype other than "bf16", "f32" or "int8" raises, naming them."""
    model, gf = load_llama(kv8_model, device="cpu")
    gf.close()
    with pytest.raises(ValueError, match="'bf16', 'f32' or 'int8'"):
        model.init_cache(1, "fp8")


# ---- the slice under ZGML_TPU_ATTN_I8PV=1 ----------------------------------------------

# the d 512 config with max_seq_len 384 (K8's blocks are 128 keys) and a
# 140-token prompt: prefill in chunks of 128 (K9), batch-2 decode through
# K8's I8PV mode over JAX blocks 0 and 1; under FLAGS, and at the JAX
# default ZGML_TPU_PREFILL_BF16 (K9's and K2's bf16 forms over the int8
# cache, which the flag itself leaves alone)
I8PV_CFG = dataclasses.replace(KV8_CFG, max_seq_len=384)
I8PV_PROMPT = 140
I8PV_FLAGS = {**FLAGS, "ZGML_TPU_ATTN_I8PV": "1"}
I8PV_BF16_FLAGS = {**I8PV_FLAGS, "ZGML_TPU_PREFILL_BF16": "1"}


@pytest.fixture(scope="module", params=[I8PV_FLAGS, I8PV_BF16_FLAGS],
                ids=["prefill-f32", "prefill-bf16"])
def i8pv_run(request, tmp_path_factory):
    assert attention.k8_block(I8PV_CFG.max_seq_len) == 128
    path = str(tmp_path_factory.mktemp("torch_kv8_i8pv") / "d512_s384_q4.gguf")
    write_synthetic_llama_gguf(path, I8PV_CFG, seed=24)
    jax.clear_caches()          # the JAX forward reads the flags when it traces
    run = _slice_run(path, 2, 128, I8PV_CFG, I8PV_PROMPT, request.param)
    run["bf16"] = request.param["ZGML_TPU_PREFILL_BF16"] == "1"
    # at the bf16 prefill the cache's int8 levels of bf16-form K and V flip
    # under sums in another order: its bounds are flip-aware
    moves = (_port_moves(path, 2, 128, run["prompt"], run["feed"], request.param)
             if run["bf16"] else (0.0, 0.0))
    run["rtol"] = [max(I8_RTOL, SENS_MARGIN * m) for m in moves]
    return run


def test_i8pv_prefill_logits_match_jax(i8pv_run):
    """The prefill (K9, which the flag does not change; in its bf16 form at
    the default ZGML_TPU_PREFILL_BF16) within the int8 tier's 1e-2 *
    max|logit|, at the bf16 prefill or SENS_MARGIN x the port's own move
    under 1e-7 embedding perturbations, the larger."""
    _close(i8pv_run["port"][0], i8pv_run["jax"][0], i8pv_run["rtol"][0])


def test_i8pv_steps_and_greedy_tokens_match_jax(i8pv_run):
    """The batch-2 decode steps through K8's I8PV mode on both sides: each
    step's logits within 1e-2 * max|logit| (at the bf16 prefill, or
    SENS_MARGIN x the port's own move, the larger), the greedy tokens equal
    as in test_kv8_steps_and_greedy_tokens_match_jax."""
    _steps_and_tokens_match(i8pv_run, i8pv_run["rtol"][1])


def test_i8pv_step_from_carried_cache_matches_jax(i8pv_run):
    """One I8PV decode step from the JAX int8 cache carried over: the same
    inputs on both sides, within 1e-5 * max|logit|."""
    _close(i8pv_run["carried"], i8pv_run["jax"][1][0])


def test_i8pv_run_takes_k8_i8pv(i8pv_run):
    """Placement under the flag: prefill K9 (2 chunks a layer; its bf16 form
    at the default ZGML_TPU_PREFILL_BF16), decode K8's I8PV mode once a
    layer a step, and no f32-p K8 or bf16-cache kernel."""
    tiers, n_layers = i8pv_run["tiers"], I8PV_CFG.n_layers
    k9, other = "flash_attention_q8_bf16", "flash_attention_q8"
    if not i8pv_run["bf16"]:
        k9, other = other, k9
    assert tiers[k9] == {"ref": 2 * n_layers}
    assert tiers["decode_attention_q8_i8pv"] == {"ref": N_STEPS * n_layers}
    assert not set(tiers) & {"decode_attention_q8", "attention", "decode_attention",
                             "attn_block", "attn_block_kv8", other}, tiers
