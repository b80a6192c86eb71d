"""zgml_tpu_torch.parallel on the CPU against the JAX package's parallel/.

The port's ranks are processes of a gloo world (parallel/world.World,
init_method file:// under a temporary directory), spawned once for the
module; the JAX side runs as its own tests run it, on the conftest's 8
virtual CPU devices (Pallas kernels in interpret mode). The same inputs,
drawn from a seed with numpy (or the same synthetic GGUF), go through both.

Bounds, each stated where it is used:
  - weight shards: bit-equal (a shard is a slice of the same blocks);
  - the f32 TP forward (dense weights, ZGML_TPU_PREFILL_BF16=0): 1e-5 of
    max|logit| (the psum and GEMM sums in another order);
  - the quantized TP forward and decode, whose int8 tiers (K1, K7's int8 q
    over the int8 cache) round the activations: 1e-2 of max|logit|, the
    flips ROADMAP.md C records for whole-model int8 checks;
  - ring attention and the CP prefill's logits: 1e-5 of max|o| / max|logit|
    (the same f32 function merged in another order; the bf16 hop's p
    roundings agree because both round the same f32 scores);
  - the CP prefill's cache: bf16 K/V within one bf16 ulp of the JAX cache
    (a K value's f32 sums round to bf16 either side of a tie) or 1e-5 of
    max|K| (a K near zero), int8 levels within one level and their scales
    within 2e-5 relative (each the absmax of f32 K whose layer-1 input was
    summed in another order: 7.4e-6 measured).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_tasks as tasks
from zgml_tpu.io.gguf import GGMLType as JGGMLType
from zgml_tpu.io.llama_loader import load_llama as jax_load_llama
from zgml_tpu.models.llama import LlamaConfig as JCfg, LlamaModel as JModel, _LocalCfgView
from zgml_tpu.models.llama import init_params as jax_init_params
from zgml_tpu.parallel import make_mesh as jax_make_mesh
from zgml_tpu.parallel import make_sharded_forward as jax_sharded_forward
from zgml_tpu.parallel import shard_llama_params as jax_shard_params
from zgml_tpu.parallel.tp import shard_layer_fused, shard_llama_params_fused
from zgml_tpu.parallel.tp import shard_packed as jax_shard_packed
from zgml_tpu.quant.repack import dequant_packed, quantize_weight
from zgml_tpu.utils.synthetic import write_synthetic_llama_gguf as jax_write_gguf

from zgml_tpu_torch.io.llama_loader import load_llama
from zgml_tpu_torch.models.llama import LlamaConfig
from zgml_tpu_torch.parallel.tp import shard_layer, shard_packed
from zgml_tpu_torch.parallel.world import World
from zgml_tpu_torch.quant import packed
from zgml_tpu_torch.runtime.engine import LlamaEngine

torch.set_num_threads(2)

WORLD_TIMEOUT = 120          # seconds a rank may take for one test's function
# the JAX flags both packages read, set around both sides (tests/test_torch_llama.py)
JAX_DEFAULTS = {"ZGML_TPU_SCALES": "f16"}
F32 = {**JAX_DEFAULTS, "ZGML_TPU_PREFILL_BF16": "0"}


@pytest.fixture(scope="module")
def world():
    with World(4, backend="gloo", device="cpu") as w:
        yield w


def _env(mp, flags):
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


def _port_cfg(jcfg) -> LlamaConfig:
    return LlamaConfig(**dataclasses.asdict(jcfg))


def _by_dp(results, key, dp):
    """Rank outputs `key` of tp index 0 of each dp group, in dp order."""
    first = {}
    for r in results:
        first.setdefault(r["dp"], r[key])
    return np.concatenate([first[i] for i in range(dp)], axis=0)


# -- shard_packed and shard_layer: bit-equal to the JAX shards -------------------------

@pytest.mark.parametrize("kind", ["q8_0", "q4_0"])
@pytest.mark.parametrize("axis,tp", [("n", 2), ("n", 4), ("k", 2), ("k", 4)])
def test_shard_packed_matches_jax(kind, axis, tp):
    """Each port shard dequantizes bit-equal to JAX's local shard of the same
    weight and to the slice of the global dequantized weight."""
    rng = np.random.default_rng(3)
    n, k = 96, 256
    jpw = quantize_weight(rng.standard_normal((n, k)).astype(np.float32), kind)
    full = dequant_packed(jpw)
    pw = (packed.from_planar_q4_0 if kind == "q4_0" else packed.from_planar_q8_0)(
        np.asarray(jpw.qvals), np.asarray(jpw.scales), n, k, device="cpu")
    spw = jax_shard_packed(jpw, tp, axis)
    for t, mine in enumerate(shard_packed(pw, tp, axis)):
        if axis == "n":
            cols = slice(t * spw.n_pad, (t + 1) * spw.n_pad)
            local = dataclasses.replace(spw, qvals=np.asarray(spw.qvals)[:, cols],
                                        scales=np.asarray(spw.scales)[:, cols])
            want = full[t * spw.n:(t + 1) * spw.n]
        else:
            rows = spw.k_pad // 2 if kind == "q4_0" else spw.k_pad
            sb = spw.k_pad // 32
            local = dataclasses.replace(spw, qvals=np.asarray(spw.qvals)[t * rows:(t + 1) * rows],
                                        scales=np.asarray(spw.scales)[t * sb:(t + 1) * sb])
            want = full[:, t * spw.k:(t + 1) * spw.k]
        np.testing.assert_array_equal(mine.dequant().numpy(), dequant_packed(local))
        np.testing.assert_array_equal(mine.dequant().numpy(), want)


def test_shard_packed_refusals():
    pw = packed.from_int8(np.zeros((96, 96), np.int8), np.ones((96, 3), np.float16), "cpu")
    with pytest.raises(ValueError, match="not divisible"):
        shard_packed(pw, 5, "n")
    with pytest.raises(ValueError, match="not divisible"):
        shard_packed(pw, 5, "k")
    with pytest.raises(ValueError, match="not a multiple of 32"):
        shard_packed(pw, 2, "k")
    with pytest.raises(ValueError, match="axis"):
        shard_packed(pw, 2, "x")


Q4_CFG = JCfg(vocab_size=256, d_model=256, n_heads=8, n_kv_heads=4, d_ff=512, n_layers=2,
              max_seq_len=64)


@pytest.fixture(scope="module")
def q4_gguf(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tp_q4") / "tp_q4.gguf")
    jax_write_gguf(path, Q4_CFG, JGGMLType.Q4_0, seed=5)
    return path


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_layer_matches_jax(q4_gguf, monkeypatch, tp):
    """Mirror of test_shard_layer_fused_views_exact: every shard's wqkv,
    wo, w_gate_up and w_down dequantize bit-equal to JAX's
    shard_layer_fused shard of the same layer (its logical columns: gate and
    up are each part-padded there)."""
    _env(monkeypatch, JAX_DEFAULTS)          # the file's fp16 scales, as the port keeps them
    jmodel, gf = jax_load_llama(q4_gguf, mode="quantized")
    gf.close()
    model, gf = load_llama(q4_gguf, device="cpu")
    gf.close()
    stacked, _ = shard_layer_fused(jmodel.params["layers"][1], Q4_CFG, tp)
    f_l = Q4_CFG.d_ff // tp
    for t in range(tp):
        mine = shard_layer(model.params["layers"][1], Q4_CFG, tp, t)
        for name, axis in (("wqkv", "n"), ("w_gate_up", "n"), ("wo", "k"), ("w_down", "k")):
            pw = stacked[name]
            if axis == "n":
                cols = slice(t * pw.n_pad, (t + 1) * pw.n_pad)
                local = dataclasses.replace(pw, qvals=np.asarray(pw.qvals)[:, cols],
                                            scales=np.asarray(pw.scales)[:, cols])
            else:
                rows = pw.k_pad // 2
                sb = pw.k_pad // 32
                local = dataclasses.replace(pw, qvals=np.asarray(pw.qvals)[t * rows:(t + 1) * rows],
                                            scales=np.asarray(pw.scales)[t * sb:(t + 1) * sb])
            want = dequant_packed(local)
            if name == "w_gate_up":
                half = pw.n_pad // 2
                want = np.concatenate([want[:f_l], want[half:half + f_l]])
            np.testing.assert_array_equal(mine[name].dequant().numpy(), want, err_msg=name)
        for name in ("attn_norm", "ffn_norm"):
            np.testing.assert_array_equal(mine[name].numpy(), np.asarray(stacked[name]))


# -- the tier verdicts on the local shapes ------------------------------------------------

VERDICT_WIDTHS = {   # one layer of each model's width (a small vocabulary)
    "tinyllama": dict(d_model=2048, n_heads=32, n_kv_heads=4, d_ff=5632),
    "llama2_7b": dict(d_model=4096, n_heads=32, n_kv_heads=32, d_ff=11008),
}


def _jax_verdicts(widths: dict, tp: int) -> dict:
    """JAX's decisions on each shard's local dict (shard_layer_fused):
    K7 or not and its A phase, the FFN after K7 (K6c / K6d / composed) and
    the FFN of <= 32 rows in _layer_step (K6b or composed)."""
    from zgml_tpu import config as jconfig
    from zgml_tpu.ops.ffn import ffn_compatible
    from zgml_tpu.ops.layerkernel import attn_block_compatible
    from zgml_tpu.quant.headmajor import attach_head_major
    from zgml_tpu.quant.repack import concat_packed, repack_gguf_tensor
    cfg = JCfg(vocab_size=256, n_layers=1, max_seq_len=64, **widths)
    d, hd, f = cfg.d_model, cfg.head_dim, cfg.d_ff

    def pw(n, k, **kw):       # the layer's shapes and pads; the values do not matter
        return repack_gguf_tensor("q4_0", np.zeros(n * k // 32 * 18, np.uint8), n, k, **kw)
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    wd = pw(d, f)
    layer = {"attn_norm": np.ones(d, np.float32), "ffn_norm": np.ones(d, np.float32),
             "wqkv": concat_packed([pw(nq, d, n_align=1), pw(nkv, d, n_align=1),
                                    pw(nkv, d, n_align=1)]),
             "wo": pw(d, nq), "w_down": wd,
             "w_gate_up": concat_packed([pw(f, d, n_align=1), pw(f, d, n_align=1)],
                                        part_pad=wd.k_pad)}
    attach_head_major(layer, cfg.n_heads, cfg.n_kv_heads, hd)
    loc, _ = shard_layer_fused(layer, cfg, tp)
    kcfg = _LocalCfgView(cfg.n_heads // tp, cfg.n_kv_heads // tp, hd, d, cfg.rms_norm_eps)
    cache = np.zeros((1, cfg.n_kv_heads // tp, 64, hd), np.float32)
    dp = loc["wqkv"].k_pad
    after = ("i8" if jconfig.ffn_i8a(dp) else "f32") if "ffn_q4n" in loc else \
        "f32" if ffn_compatible(loc["w_gate_up"], loc["w_down"]) else None
    return {"k7": attn_block_compatible(loc, kcfg, cache), "a_i8": jconfig.attn_i8a(dp),
            "after_k7": after, "planar": ffn_compatible(loc["w_gate_up"], loc["w_down"])}


def _port_verdicts(c: dict) -> dict:
    """The same decisions read from the port's counters of one TP decode
    step (K7, then K6) and one 16-row prefill chunk (K6b)."""
    dec, pre = c["counts"], c["prefill_counts"]
    k7 = {k for k in dec if k.startswith("attn_block")}
    after = ("i8" if any(k.startswith("fused_ffn_norm_i8") for k in dec) else
             "f32" if any(k.startswith("fused_ffn_norm/") for k in dec) else None)
    return {"k7": bool(k7), "a_i8": any("attn_block_i8" in k for k in k7),
            "after_k7": after, "planar": any(k.startswith("fused_ffn/") for k in pre)}


@pytest.mark.parametrize("model", sorted(VERDICT_WIDTHS))
def test_tier_verdicts_on_local_shapes(world, monkeypatch, model):
    """At TinyLlama-1.1B and Llama-2-7B widths (one layer) and tp 2, each
    rank's K7 (and its A phase), its FFN after K7 (K6c, K6d or composed) and
    its FFN of <= 32 rows (K6b) are the ones JAX's verdicts on its local
    dict name: at TinyLlama K7's f32 A phase and K6d, at 7B the int8 A phase
    and K6c, K6b at both."""
    _env(monkeypatch, JAX_DEFAULTS)
    want = _jax_verdicts(VERDICT_WIDTHS[model], 2)
    cfg = LlamaConfig(vocab_size=256, n_layers=1, max_seq_len=64, **VERDICT_WIDTHS[model])
    toks = np.arange(32).reshape(2, 16) % 256
    res = world.run(tasks.tp_forward, ("zeros", cfg, "q4_0"), 2, 2, toks, toks[:, :1],
                    timeout=WORLD_TIMEOUT, env=JAX_DEFAULTS)
    assert want == {"k7": True, "a_i8": model == "llama2_7b",
                    "after_k7": "i8" if model == "llama2_7b" else "f32", "planar": True}
    for r in res:
        assert _port_verdicts(r) == want, (r["counts"], r["prefill_counts"])
        assert not any(k.endswith("/cuda") for k in r["counts"])


# -- the TP forward against JAX's make_sharded_forward ------------------------------------

F32_CFG = JCfg(vocab_size=256, d_model=64, n_heads=8, n_kv_heads=4, d_ff=128, n_layers=2,
               max_seq_len=32)


def _jax_tp(model, params, mesh, tokens, steps, cache):
    fwd = jax_sharded_forward(model, mesh)
    logits, cache = fwd(params, jnp.asarray(tokens, jnp.int32), cache, 0)
    step, _ = fwd(params, jnp.asarray(steps, jnp.int32), cache, tokens.shape[1])
    return np.asarray(logits), np.asarray(step)


def _close(got, want, rtol, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max_abs_err {err:.3g} > {rtol:g} x max|want| {scale:.3g}"


@pytest.mark.parametrize("tp,dp", [(2, 2), (4, 1)])
def test_tp_forward_f32_matches_jax(world, monkeypatch, tp, dp):
    """Dense f32 weights (JAX's init_params, seed 0), prefill of [2, 8]
    tokens then one decode step, at tp 2 x dp 2 and tp 4: within 1e-5 of
    max|logit| of JAX's make_sharded_forward."""
    _env(monkeypatch, F32)
    jparams = jax_init_params(F32_CFG, seed=0)
    rng = np.random.default_rng(0)
    tokens, steps = rng.integers(0, 256, (2, 8)), rng.integers(0, 256, (2, 1))
    mesh = jax_make_mesh(tp=tp, dp=dp, devices=jax.devices()[:tp * dp])
    jmodel = JModel(F32_CFG, jparams)
    want, want_step = _jax_tp(jmodel, jax_shard_params(jparams, mesh), mesh, tokens, steps,
                              jmodel.init_cache(2))
    res = world.run(tasks.tp_forward, ("jax", _port_cfg(F32_CFG), _np_params(jparams)), tp, dp,
                    tokens, steps, timeout=WORLD_TIMEOUT, env=F32)
    _close(_by_dp(res, "prefill", dp), want, 1e-5, "prefill")
    _close(_by_dp(res, "decode", dp), want_step, 1e-5, "decode")


@pytest.mark.parametrize("tp,dp", [(2, 2)])
def test_tp_forward_q4_matches_jax(world, monkeypatch, q4_gguf, tp, dp):
    """The Q4_0 GGUF at JAX's default flags: prefill of [2, 8] tokens (K1, the
    bf16 flash form, K6b) then one decode step (at dp 2 a row a rank: K7 on
    the local heads), within 1e-2 of max|logit| of JAX's make_sharded_forward
    over shard_llama_params_fused."""
    _env(monkeypatch, JAX_DEFAULTS)
    rng = np.random.default_rng(1)
    tokens, steps = rng.integers(0, 256, (2, 8)), rng.integers(0, 256, (2, 1))
    mesh = jax_make_mesh(tp=tp, dp=dp, devices=jax.devices()[:tp * dp])
    jm, gf = jax_load_llama(q4_gguf, mode="quantized")
    gf.close()
    sharded = shard_llama_params_fused(jm, mesh)
    want, want_step = _jax_tp(JModel(Q4_CFG, sharded), sharded, mesh, tokens, steps,
                              jm.init_cache(2, layout="unrolled"))
    res = world.run(tasks.tp_forward, ("gguf", q4_gguf), tp, dp, tokens, steps,
                    timeout=WORLD_TIMEOUT, env=JAX_DEFAULTS)
    _close(_by_dp(res, "prefill", dp), want, 1e-2, "prefill")
    _close(_by_dp(res, "decode", dp), want_step, 1e-2, "decode")
    if dp == 2:
        assert all(any(k.startswith("attn_block") for k in r["counts"]) for r in res)


D512_CFG = JCfg(vocab_size=256, d_model=512, n_heads=8, n_kv_heads=4, d_ff=1024, n_layers=2,
                max_seq_len=64)


@pytest.fixture(scope="module")
def d512_gguf(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tp_d512") / "tp_d512.gguf")
    jax_write_gguf(path, D512_CFG, JGGMLType.Q4_0, seed=5)
    return path


@pytest.mark.parametrize("i8a", ["0", "1"])
def test_tp_fused_decode_matches_jax(world, monkeypatch, d512_gguf, i8a):
    """Mirror of test_tp_fused_decode_matches_single_device at d 512: a
    6-token prefill, then one decode token through K7 on the local heads and
    the fused FFN after it (K6d; with ZGML_TPU_ATTN_I8A / FFN_I8A=1 K7's int8
    A phase and K6c), at tp 2 (dp 2, a row a rank), against JAX's TP decode
    and the port's own single-process decode: 1e-2 of max|logit|."""
    flags = {**JAX_DEFAULTS, "ZGML_TPU_ATTN_I8A": i8a, "ZGML_TPU_FFN_I8A": i8a}
    _env(monkeypatch, flags)
    prompt = np.random.default_rng(7).integers(0, 256, (1, 6))
    tokens, steps = np.repeat(prompt, 2, 0), np.array([[11], [11]])
    mesh = jax_make_mesh(tp=2, dp=2, devices=jax.devices()[:4])
    jm, gf = jax_load_llama(d512_gguf, mode="quantized")
    gf.close()
    sharded = shard_llama_params_fused(jm, mesh)
    _, want = _jax_tp(JModel(D512_CFG, sharded), sharded, mesh, tokens, steps,
                      jm.init_cache(2, layout="unrolled"))
    res = world.run(tasks.tp_forward, ("gguf", d512_gguf), 2, 2, tokens, steps,
                    timeout=WORLD_TIMEOUT, env=flags)
    got = _by_dp(res, "decode", 2)
    _close(got, want, 1e-2, "TP decode vs JAX")
    single = tasks.build_model(("gguf", d512_gguf))
    cache = single.init_cache(1)
    with torch.inference_mode():
        single(torch.as_tensor(prompt), cache, 0)
        one = single(torch.tensor([[11]]), cache, 6).numpy()
    _close(got[:1], one, 1e-2, "TP decode vs one process")
    a, f = (("attn_block_i8", "fused_ffn_norm_i8") if i8a == "1"
            else ("attn_block", "fused_ffn_norm"))
    for r in res:
        assert r["counts"].get(f"{a}/ref") == 2 and r["counts"].get(f"{f}/ref") == 2, r["counts"]


def test_unsharded_params_refused(world, q4_gguf):
    """make_sharded_forward refuses params that were never sharded, as JAX's."""
    res = world.run(tasks.unsharded_refused, ("gguf", q4_gguf), 2, timeout=WORLD_TIMEOUT)
    assert all("not TP-sharded" in r for r in res), res


# -- ring attention and the context-parallel prefill --------------------------------------

@pytest.mark.parametrize("causal,flags", [
    (True, {}), (True, {"ZGML_TPU_PREFILL_BF16": "0"}),
    (True, {"ZGML_TPU_KERNELS_DISABLE": "ring_attention"}), (False, {})],
    ids=["kernel_tier", "kernel_tier_f32", "plain_tier", "noncausal"])
def test_ring_attention_matches_jax(world, monkeypatch, causal, flags):
    """GQA ring attention over 4 ranks (t_loc 24): the kernel tier (one K10f
    hop a visiting block, LSE merge; its bf16 form, or under
    ZGML_TPU_PREFILL_BF16=0 its f32-K/V form over the f32 K/V, as JAX's),
    the plain tier and the non-causal form, each against JAX's
    make_ring_attention under the same flags (its kernel tier in interpret
    mode): 1e-5 of max|o|."""
    flags = {**JAX_DEFAULTS, **flags}
    _env(monkeypatch, flags)
    from zgml_tpu.parallel.ring import make_ring_attention
    rng = np.random.default_rng(9)
    b, hq, hkv, t, d = 2, 4, 2, 96, 32
    q = rng.standard_normal((b, hq, t, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, t, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, t, d)).astype(np.float32)
    mesh = jax_make_mesh(tp=4, dp=1, devices=jax.devices()[:4])
    want = np.asarray(make_ring_attention(mesh, axis="tp", causal=causal)(q, k, v))
    res = world.run(tasks.ring, q, k, v, causal, timeout=WORLD_TIMEOUT, env=flags)
    _close(np.concatenate([r["out"] for r in res], axis=2), want, 1e-5, "ring attention")
    kernel = causal and not flags.get("ZGML_TPU_KERNELS_DISABLE")
    hop = "flash_fwd_f32kv" if flags.get("ZGML_TPU_PREFILL_BF16") == "0" else "flash_fwd_bf16"
    for idx, r in enumerate(res):
        assert r["counts"] == ({"ring_attention/ref": 1, f"{hop}/ref": idx + 1}
                               if kernel else {"ring_attention/ref": 1})
        if kernel:       # rank idx skips the 3 - idx blocks that lie wholly in its future
            assert r["hops"] == {k: n for k, n in (("ring_hops", idx + 1),
                                                   ("ring_hops_skipped", 3 - idx)) if n}


CP_CFG = JCfg(vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, n_layers=2,
              max_seq_len=2056)


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
def test_cp_prefill_2048_matches_jax(world, monkeypatch, cache_dtype):
    """A 2048-token prompt over cp 4 (f32 prefill operands, both packages):
    LlamaEngine.prefill_cp's last logits, its cache and one decode step after
    it against JAX's prefill_cp (module note: logits 1e-5 of max, bf16 K/V
    one ulp, int8 levels one level) and against the port's own chunked
    prefill (logits 2e-3 of max: that prefill attends over its rounded
    cache, so its later layers' K/V and the decode step after it move too)."""
    _env(monkeypatch, F32)
    from zgml_tpu.runtime.engine import LlamaEngine as JEngine
    jparams = jax_init_params(CP_CFG, seed=11)
    prompt = np.random.default_rng(12).integers(0, 128, 2048)
    mesh = jax_make_mesh(tp=4, dp=1, axis_names=("dp", "cp"), devices=jax.devices()[:4])
    jeng = JEngine(JModel(CP_CFG, jparams), cache_dtype="int8" if cache_dtype == "int8"
                   else jnp.bfloat16, donate_cache=False)
    want = np.asarray(jeng.prefill_cp(prompt.astype(np.int32), mesh))
    src = ("jax", _port_cfg(CP_CFG), _np_params(jparams))
    res = world.run(tasks.cp_prefill, src, prompt, cache_dtype, timeout=WORLD_TIMEOUT, env=F32)
    chunked = LlamaEngine(tasks.build_model(src), cache_dtype=cache_dtype)
    base = chunked.prefill(prompt).numpy()
    for idx, r in enumerate(res):
        _close(r["last"], want, 1e-5, "prefill_cp vs JAX")
        # the chunked prefill attends over its bf16 (or int8) cache, the CP
        # prefill over the f32 K/V (as JAX's): 2e-3 of max covers K/V rounded
        # to bf16 (relative 2^-9) through two layers
        _close(r["last"], base, 2e-3, "prefill_cp vs chunked prefill")
        np.testing.assert_array_equal(r["cache"]["k"], res[0]["cache"]["k"])
        # a ring call a layer; rank idx runs idx + 1 K10f hops (its f32-K/V
        # form here)
        assert r["counts"]["ring_attention/ref"] == CP_CFG.n_layers
        assert r["counts"]["flash_fwd_f32kv/ref"] == CP_CFG.n_layers * (idx + 1)
    jk = jeng.cache["k"]
    if cache_dtype == "bf16":
        jk = np.asarray(jk[:, :, :, :2048]).astype(np.float32)
        k = res[0]["cache"]["k"]
        # one bf16 ulp of the larger, or 1e-5 of max|K| where a near-zero K
        # moves by more ulps than its f32 sums' difference is large
        ulp = np.ldexp(1.0, np.frexp(np.maximum(np.abs(k), np.abs(jk)))[1] - 8)
        diff = np.abs(k - jk)
        assert np.all(diff <= np.maximum(ulp, 1e-5 * np.abs(jk).max())), \
            (float((diff / ulp).max()), float(diff[diff > ulp].max()), float(np.abs(jk).max()))
    else:
        jk_q = np.asarray(jk[0]).swapaxes(-1, -2)[:, :, :, :2048].astype(np.float32)
        jk_s = np.asarray(jk[1])[:, :, :, :2048]
        assert np.abs(res[0]["cache"]["k"] - jk_q).max() <= 1
        np.testing.assert_allclose(res[0]["cache"]["k_s"], jk_s, rtol=2e-5)
    tok = int(np.argmax(res[0]["last"]))
    _, jstep = jeng.step(np.array([tok]))
    _close(res[0]["step"], np.asarray(jstep), 1e-5, "decode after prefill_cp vs JAX's")
    step_base = chunked.step(torch.tensor([tok]))[1].numpy()
    _close(res[0]["step"], step_base, 2e-3, "decode after prefill_cp vs after chunked prefill")


def test_tp_collectives_forward_and_backward(world):
    """The TP collectives of models/llama carry JAX's custom VJPs
    (llama.py:129-200) on 4 ranks, rank r feeding x (r + 1) and weighing its
    output by (r + 1) * [1 .. n] in its loss: _tp_copy is the identity with a
    psum backward, _tp_reduce a psum with an identity backward, _tp_gather an
    all_gather of the last axis whose backward takes the rank's own slice."""
    x = np.random.default_rng(0).standard_normal((3, 4)).astype(np.float32)
    res = world.run(tasks.tp_collectives, x, timeout=WORLD_TIMEOUT)
    n, ramp = len(res), np.arange(1, 5, dtype=np.float32)
    total = sum(r + 1 for r in range(n))
    for r, out in enumerate(res):
        w = r + 1
        y, g = out["copy"]
        np.testing.assert_array_equal(y, x * w)
        np.testing.assert_allclose(g, np.broadcast_to(total * ramp, x.shape), rtol=1e-6)
        y, g = out["reduce"]
        np.testing.assert_allclose(y, x * total, rtol=1e-6)
        np.testing.assert_array_equal(g, np.broadcast_to(w * ramp, x.shape))
        y, g = out["gather"]
        np.testing.assert_array_equal(y, np.concatenate([x * (i + 1) for i in range(n)], -1))
        full = w * np.arange(1, 4 * n + 1, dtype=np.float32)
        np.testing.assert_array_equal(g, np.broadcast_to(full[r * 4:(r + 1) * 4], x.shape))
