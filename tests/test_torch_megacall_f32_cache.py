"""The whole-stack decode megacalls K14 / K15 over the f32 KV cache: the port
against the JAX package on the CPU.

The JAX megacalls read the stacked cache through .astype(jnp.float32)
(zgml_tpu/ops/stackkernel.py:159, 173; tapekernel.py:359, 373) and write each
layer's new row cast to the cache's dtype (stackkernel.py:529-530;
tapekernel.py:590-593), and JAX's forward sends a batch-1 decode over any
stacked cache to them (models/llama.py:745-771). The JAX kernels run in
interpret mode (tests/conftest.py), the port its plain versions (CPU
tensors), on the configs of tests/test_torch_stackkernel.py (K14: d 512, 8/2
heads, 3 layers, ZGML_TPU_SCALES=f16) and tests/test_torch_tapekernel.py
(K15: d 1024, 16/4 heads, 2 layers, ZGML_TPU_SCALES=f32: the JAX tape under
f16 storage carries other FFN scales, ROADMAP.md's reference weak spots),
each loading one synthetic GGUF into both packages.

Bounds: one decode step from a shared f32 cache, x_out, k_cur and v_cur
within 1e-5 * max|ref| with f32 operands (sums in another order) and
BF16_RTOL * max|ref| with K15's bf16 operands (tests/test_torch_tapekernel.py:
an operand the two sides sum in another order can round to either bf16
neighbour); every layer's cache row pos is the port's own k_cur / v_cur bit
for bit and within that bound of JAX's row, every other row as it was. The
engines over the f32 cache (LlamaEngine(cache_dtype="f32") against JAX's
cache_dtype=jnp.float32) give JAX's greedy tokens under
ZGML_TPU_STACK_DECODE=1 and under ZGML_TPU_TAPE_DECODE=1, up to the first
step whose JAX top-2 gap is under I8_RTOL * max|logit| (K5's int8 head and
K15's bf16 roundings flip there), each decode step through the megacall's
f32-cache mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zgml_tpu.ops import refs as jrefs
from zgml_tpu.ops import stackkernel as jstack
from zgml_tpu.ops import tapekernel as jtape
from zgml_tpu.runtime.engine import LlamaEngine as JaxEngine
from zgml_tpu.runtime.profile import global_profile as jax_profile

from zgml_tpu_torch.ops import dispatch, refs
from zgml_tpu_torch.runtime.engine import LlamaEngine
from zgml_tpu_torch.runtime.profile import global_profile

from test_torch_stackkernel import CFG as STACK_CFG, _both, _gguf
from test_torch_stackkernel import _flags as _stack_flags
from test_torch_tapekernel import CFG as TAPE_CFG

torch.set_num_threads(1)

REL = 1e-5
BF16_RTOL = 1e-2           # tests/test_torch_tapekernel.py BF16_RTOL
I8_RTOL = 1e-2             # the engines' token gap bound (tests/test_torch_f32_cache.py)
N_STEPS = 8
POS = (0, 1, 37)


def _stack_env(mp, **flags):
    _stack_flags(mp, **flags)


def _tape_env(mp, **flags):
    _stack_flags(mp, ZGML_TPU_SCALES="f32", **flags)


@pytest.fixture(scope="module")
def stack_models(tmp_path_factory):
    path = _gguf(tmp_path_factory.mktemp("mega_f32_stack"), STACK_CFG)
    with pytest.MonkeyPatch.context() as mp:
        _stack_env(mp)
        jm, pm = _both(path)
        assert jm.enable_stacked_decode() and pm.enable_stacked_decode()
    return jm, pm


@pytest.fixture(scope="module")
def tape_models(tmp_path_factory):
    path = _gguf(tmp_path_factory.mktemp("mega_f32_tape"), TAPE_CFG)
    with pytest.MonkeyPatch.context() as mp:
        _tape_env(mp)
        jm, pm = _both(path)
        assert jm.enable_tape_decode() and pm.enable_tape_decode()
    return jm, pm


def _inputs(rng, cfg):
    x = rng.standard_normal((1, 1, cfg.d_model)).astype(np.float32)
    shape = (cfg.n_layers, 1, cfg.n_kv_heads, cfg.max_seq_len, cfg.head_dim)
    ck, cv = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.5)
              for _ in range(2))
    return x, ck, cv


def _spied_step(monkeypatch, module, call_name, step, *args):
    """The JAX step and its kernel's own (x_out, k_cur, v_cur)."""
    seen = {}
    call = getattr(module, call_name)

    def spy(*a, **kw):
        seen["out"] = call(*a, **kw)
        return seen["out"]
    monkeypatch.setattr(module, call_name, spy)
    jx, jck, jcv = step(*args)
    _, jk, jv = seen["out"]
    return (jx, jk, jv), (jck, jcv)


def _check(got, want, jcache, pcache, cache0, pos, rel):
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        assert tuple(g.shape) == w.shape and bool(torch.isfinite(g).all())
        assert np.max(np.abs(g.numpy() - w)) <= rel * np.max(np.abs(w))
    for jc, pc, c0, cur in zip(jcache, pcache, cache0, got[1:]):
        assert torch.equal(pc[:, 0, :, pos], cur)                   # the port's own row
        jrow = np.asarray(jc[:, 0, :, pos], np.float32)
        assert np.max(np.abs(pc[:, 0, :, pos].numpy() - jrow)) <= rel * np.max(np.abs(jrow))
        rows = torch.arange(pc.shape[3]) != pos
        assert torch.equal(pc[:, :, :, rows], c0[:, :, :, rows])


@pytest.mark.parametrize("pos", POS)
def test_stacked_decode_f32_cache_step_matches_jax(stack_models, monkeypatch, pos):
    jm, pm = stack_models
    _stack_env(monkeypatch, ZGML_TPU_STACK_DECODE="1")
    cfg, hd = pm.cfg, pm.cfg.head_dim
    x, ck, cv = _inputs(np.random.default_rng(400 + pos), cfg)
    cos, sin = jrefs.rope_cos_sin(jnp.asarray([pos]), hd, cfg.rope_base)
    want, jcache = _spied_step(
        monkeypatch, jstack, "_stack_call", jstack.stacked_decode_step, jm.cfg,
        jm.params["layers_stacked"], jnp.asarray(x), jnp.asarray(ck.numpy()),
        jnp.asarray(cv.numpy()), pos, cos, sin)
    assert jcache[0].dtype == jnp.float32
    pcos, psin = refs.rope_cos_sin(torch.tensor([pos]), hd, cfg.rope_base)
    cache0 = (ck.clone(), cv.clone())
    global_profile.reset()
    got = dispatch.stacked_decode(torch.from_numpy(x), pm.params["layers_stacked"], ck, cv,
                                  torch.tensor([pos], dtype=torch.int32), pcos, psin)
    assert global_profile.tier_summary() == {"stack_decode_f32kv": {"ref": 1}}
    _check(got, want, jcache, (ck, cv), cache0, pos, REL)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32_ops", "bf16_ops"])
@pytest.mark.parametrize("pos", POS)
def test_tape_decode_f32_cache_step_matches_jax(tape_models, monkeypatch, pos, bf16):
    jm, pm = tape_models
    _tape_env(monkeypatch, ZGML_TPU_TAPE_DECODE="1", ZGML_TPU_TAPE_BF16="1" if bf16 else "0")
    jax.clear_caches()      # the JAX tape reads ZGML_TPU_TAPE_BF16 when it first traces
    cfg, hd = pm.cfg, pm.cfg.head_dim
    x, ck, cv = _inputs(np.random.default_rng(500 + pos), cfg)
    cos, sin = jrefs.rope_cos_sin(jnp.asarray([pos]), hd, cfg.rope_base)
    want, jcache = _spied_step(
        monkeypatch, jtape, "_tape_call", jtape.tape_decode_step, jm.cfg,
        jm.params["layers_tape"], jnp.asarray(x), jnp.asarray(ck.numpy()),
        jnp.asarray(cv.numpy()), pos, cos, sin)
    assert jcache[0].dtype == jnp.float32
    pcos, psin = refs.rope_cos_sin(torch.tensor([pos]), hd, cfg.rope_base)
    cache0 = (ck.clone(), cv.clone())
    global_profile.reset()
    got = dispatch.tape_decode(torch.from_numpy(x), pm.params["layers_tape"], ck, cv,
                               torch.tensor([pos], dtype=torch.int32), pcos, psin)
    name = "tape_decode_f32kv" if bf16 else "tape_decode_f32_f32kv"
    assert global_profile.tier_summary() == {name: {"ref": 1}}
    _check(got, want, jcache, (ck, cv), cache0, pos, BF16_RTOL if bf16 else REL)


def _gap(logits) -> float:
    top2 = np.sort(np.asarray(logits, np.float32).reshape(-1))[-2:]
    return float(top2[1] - top2[0])


@pytest.mark.parametrize("flag", ["ZGML_TPU_STACK_DECODE", "ZGML_TPU_TAPE_DECODE"])
def test_f32_cache_engine_greedy_tokens_match_jax(stack_models, tape_models, monkeypatch,
                                                  flag):
    stack = flag == "ZGML_TPU_STACK_DECODE"
    jm, pm = stack_models if stack else tape_models
    (_stack_env if stack else _tape_env)(monkeypatch, **{flag: "1"})
    jax.clear_caches()
    prompt = np.random.default_rng(7).integers(0, pm.cfg.vocab_size, 12)
    jax_profile.reset()
    jeng = JaxEngine(jm, prefill_chunk=16, cache_dtype=jnp.float32, donate_cache=False)
    logits = np.asarray(jeng.prefill(prompt))[0]
    toks, gaps, scales = [int(np.argmax(logits))], [_gap(logits)], [np.max(np.abs(logits))]
    for _ in range(N_STEPS):
        nxt, lg = jeng.step(np.array([toks[-1]], np.int32))
        lg = np.asarray(lg)[0]
        toks.append(int(np.asarray(nxt).reshape(-1)[0]))
        gaps.append(_gap(lg))
        scales.append(np.max(np.abs(lg)))
    mega = "stack_decode" if stack else "tape_decode"
    assert "pallas" in jax_profile.tier_summary()[mega]      # counted when it traces
    global_profile.reset()
    eng = LlamaEngine(pm, prefill_chunk=16, cache_dtype="f32")
    assert eng.cache["k"].dtype == torch.float32
    got = eng.generate(prompt, N_STEPS + 1)
    assert global_profile.tier_summary()[mega + "_f32kv"] == {"ref": N_STEPS}
    n = next((i for i, (g, sc) in enumerate(zip(gaps, scales)) if g < I8_RTOL * sc),
             N_STEPS + 1)
    print(f"{flag}: greedy tokens compared over {n} of {N_STEPS + 1}")
    assert got[:n] == toks[:n]
