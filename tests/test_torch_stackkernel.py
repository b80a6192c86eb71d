"""K14, the all-layers decode megacall: the port against the JAX package on
the config of tests/test_stackkernel.py (d 512, 8/2 heads, d_ff 768, 3
layers, Q4_0), both loading one synthetic GGUF, with ZGML_TPU_SCALES=f16 set
around both sides (monkeypatch); the JAX kernel runs in interpret mode.

  - enable_stacked_decode() accepts and refuses where the JAX package's does
    (Q4_0; not Q8_0, not with ZGML_TPU_ATTN_BLOCK=0 at load, not at d 256 or
    head_dim 16), and the port's view holds pointers to the resident weights,
    no copy;
  - one decode step from a shared stacked bf16 cache, the port's plain
    version (stacked_decode_ref, through dispatch.stacked_decode) against JAX's
    stacked_decode_step: x_out, k_cur and v_cur within 1e-5 * max|ref| (f32
    on both sides, sums in another order: up to 9.3e-7 here), the cache row
    pos of every layer within one bf16 ulp of JAX's (or that bound, near 0)
    and every other row untouched;
  - prefill and 4 greedy steps, the stack path against the port's default
    path (K7 + K6d per layer: the same function), within JAX's bound
    3e-3 * max|logit| (tests/test_stackkernel.py:59);
  - decode_n equals a loop of step;
  - routing: with the flag off, ZGML_TPU_KERNELS_DISABLE=stack_decode, batch
    2 or the int8 cache no stack_decode runs, and a view without its flag
    leaves the default path's placement counts as they are.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zgml_tpu.io.llama_loader import load_llama as jax_load_llama
from zgml_tpu.ops import refs as jrefs
from zgml_tpu.ops import stackkernel as jstack

from zgml_tpu_torch.io.gguf import GGMLType
from zgml_tpu_torch.io.llama_loader import load_llama
from zgml_tpu_torch.models.llama import LlamaConfig, LlamaModel
from zgml_tpu_torch.ops import dispatch, refs
from zgml_tpu_torch.ops.stackkernel import TABLE
from zgml_tpu_torch.runtime.engine import LlamaEngine
from zgml_tpu_torch.runtime.profile import global_profile
from zgml_tpu_torch.utils.synthetic import TINY_TEST, write_synthetic_llama_gguf

torch.set_num_threads(1)

CFG = LlamaConfig(vocab_size=96, d_model=512, n_heads=8, n_kv_heads=2, d_ff=768, n_layers=3,
                  max_seq_len=128)
FLAGS = ("ZGML_TPU_SCALES", "ZGML_TPU_STACK_DECODE", "ZGML_TPU_TAPE_DECODE",
         "ZGML_TPU_ATTN_BLOCK", "ZGML_TPU_KERNELS_DISABLE", "ZGML_TPU_ATTN_I8A",
         "ZGML_TPU_FFN_I8A")
REL = 1e-5                 # f32 on both sides, sums in another order
LOGIT_RTOL = 3e-3          # tests/test_stackkernel.py:59


def _flags(mp, **flags):
    for k in FLAGS:
        mp.delenv(k, raising=False)
    mp.setenv("ZGML_TPU_SCALES", "f16")
    for k, v in flags.items():
        mp.setenv(k, v)


def _gguf(tmp, cfg, quant=GGMLType.Q4_0, seed=3):
    path = str(tmp / f"m_{cfg.d_model}_{cfg.n_heads}_{quant.name}.gguf")
    write_synthetic_llama_gguf(path, cfg, quant=quant, seed=seed)
    return path


def _both(path):
    jm, jgf = jax_load_llama(path)
    jgf.close()
    pm, pgf = load_llama(path, device="cpu")
    pgf.close()
    return jm, pm


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = _gguf(tmp_path_factory.mktemp("torch_stack"), CFG)
    with pytest.MonkeyPatch.context() as mp:
        _flags(mp)
        jm, pm = _both(path)
        assert jm.enable_stacked_decode() and pm.enable_stacked_decode()
    return jm, pm


def _no_copy(view, params):
    """The view's table points at the params' own tensors."""
    for li, layer in enumerate(params["layers"]):
        for col, (key, plane) in enumerate(TABLE):
            t = layer[key] if plane is None else getattr(layer[key], plane)
            assert int(view.table[li, col]) == t.data_ptr()
            assert view.tensors[li][col] is t


@pytest.mark.parametrize("cfg,quant,attn_block", [
    (CFG, GGMLType.Q4_0, "1"), (CFG, GGMLType.Q8_0, "1"), (CFG, GGMLType.Q4_0, "0"),
    # d 256: no N-packed FFN view (padded d 256 is no multiple of 512)
    (dataclasses.replace(CFG, d_model=256, d_ff=192), GGMLType.Q4_0, "1"),
    (dataclasses.replace(TINY_TEST, max_seq_len=64), GGMLType.Q4_0, "1")])   # head_dim 16
def test_enable_stacked_decode_follows_jax(tmp_path, monkeypatch, cfg, quant, attn_block):
    _flags(monkeypatch, ZGML_TPU_ATTN_BLOCK=attn_block)
    jm, pm = _both(_gguf(tmp_path, cfg, quant))
    want = jm.enable_stacked_decode()
    got = pm.enable_stacked_decode()
    assert got == want == (cfg is CFG and quant == GGMLType.Q4_0 and attn_block == "1")
    assert ("layers_stacked" in pm.params) == got
    if got:
        _no_copy(pm.params["layers_stacked"], pm.params)


def _shared_inputs(rng, cfg, s):
    hd = cfg.head_dim
    x = rng.standard_normal((1, 1, cfg.d_model)).astype(np.float32)
    shape = (cfg.n_layers, 1, cfg.n_kv_heads, s, hd)
    ck = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.5).bfloat16()
    cv = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.5).bfloat16()
    return x, ck, cv


def jax_cache(ck, cv):
    return (jnp.asarray(ck.float().numpy(), jnp.bfloat16),
            jnp.asarray(cv.float().numpy(), jnp.bfloat16))


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 numbers at |x| (frexp / ldexp, exact)."""
    ax = x.double().abs()
    _, e = torch.frexp(torch.where(ax > 0, ax, torch.full_like(ax, 2.0 ** -126)))
    return torch.ldexp(torch.ones_like(ax), e - 8)


def check_step(got, want, jcache, pcache, cache0, pos, rel):
    """x_out, k_cur, v_cur within rel * max|want|; every layer's cache row pos
    within one bf16 ulp of JAX's, or rel * max|row| where that is more (a
    value near 0 rounds to bf16 finer than the f32 sums agree), every other
    row as it was."""
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        assert tuple(g.shape) == w.shape and bool(torch.isfinite(g).all())
        err = np.max(np.abs(g.numpy() - w))
        assert err <= rel * np.max(np.abs(w)), (err / np.max(np.abs(w)), rel)
    for jc, pc, c0 in zip(jcache, pcache, cache0):
        jrow = torch.from_numpy(np.asarray(jc[:, 0, :, pos], np.float32)).double()
        prow = pc[:, 0, :, pos].double()
        tol = torch.clamp(bf16_ulp(jrow), min=rel * float(jrow.abs().max()))
        assert bool(((prow - jrow).abs() <= tol).all())
        rows = torch.arange(pc.shape[3]) != pos
        assert torch.equal(pc[:, :, :, rows], c0[:, :, :, rows])


@pytest.mark.parametrize("pos", [0, 1, 37])
def test_stacked_decode_step_matches_jax(models, monkeypatch, pos):
    jm, pm = models
    _flags(monkeypatch, ZGML_TPU_STACK_DECODE="1")
    cfg, hd = pm.cfg, pm.cfg.head_dim
    x, ck, cv = _shared_inputs(np.random.default_rng(200 + pos), cfg, cfg.max_seq_len)
    cos, sin = jrefs.rope_cos_sin(jnp.asarray([pos]), hd, cfg.rope_base)
    seen = {}
    call = jstack._stack_call

    def spy(*args, **kw):
        seen["out"] = call(*args, **kw)
        return seen["out"]
    monkeypatch.setattr(jstack, "_stack_call", spy)
    jx, jck, jcv = jstack.stacked_decode_step(jm.cfg, jm.params["layers_stacked"],
                                              jnp.asarray(x), *jax_cache(ck, cv), pos, cos, sin)
    _, jk, jv = seen["out"]

    pcos, psin = refs.rope_cos_sin(torch.tensor([pos]), hd, cfg.rope_base)
    ck0, cv0 = ck.clone(), cv.clone()
    global_profile.reset()
    got = dispatch.stacked_decode(torch.from_numpy(x), pm.params["layers_stacked"], ck, cv,
                                  torch.tensor([pos], dtype=torch.int32), pcos, psin)
    assert global_profile.tier_summary() == {"stack_decode": {"ref": 1}}
    check_step(got, (jx, jk, jv), (jck, jcv), (ck, cv), (ck0, cv0), pos, REL)


def _greedy_steps(model, prompt, n):
    eng = LlamaEngine(model, prefill_chunk=16)
    logits = eng.prefill(prompt)
    tok, out = torch.argmax(logits, dim=-1), [logits[0]]
    for _ in range(n):
        tok, lg = eng.step(tok)
        out.append(lg[0])
    return out


def test_stack_path_matches_default_path(models, monkeypatch):
    """Prefill and 4 greedy steps through K14 against the same model's
    default path (the view attached, its flag off)."""
    _, pm = models
    prompt = [1, 5, 9, 2, 7]
    _flags(monkeypatch)
    default = _greedy_steps(pm, prompt, 4)
    _flags(monkeypatch, ZGML_TPU_STACK_DECODE="1")
    global_profile.reset()
    stack = _greedy_steps(pm, prompt, 4)
    tiers = global_profile.tier_summary()
    assert tiers["stack_decode"] == {"ref": 4} and "attn_block" not in tiers
    for a, b in zip(default, stack):
        assert float((a - b).abs().max()) <= LOGIT_RTOL * float(a.abs().max())


def test_stack_decode_n_equals_steps(models, monkeypatch):
    _, pm = models
    _flags(monkeypatch, ZGML_TPU_STACK_DECODE="1")
    e1, e2 = LlamaEngine(pm), LlamaEngine(pm)
    e1.prefill([3, 1, 4])
    e2.prefill([3, 1, 4])
    toks = e1.decode_n([7], 4)[:, 0].tolist()
    got = [7]
    for _ in range(4):
        got.append(int(e2.step([got[-1]])[0][0]))
    assert toks == got[1:]


def _tiers(model, batch=1, cache="bf16"):
    global_profile.reset()
    eng = LlamaEngine(model, batch=batch, prefill_chunk=16, cache_dtype=cache)
    logits = eng.prefill(np.tile([1, 5, 9], (batch, 1)))
    eng.decode_n(torch.argmax(logits, dim=-1), 2)
    return global_profile.tier_summary()


@pytest.mark.parametrize("case", ["flag off", "disabled", "batch 2", "int8 cache"])
def test_stack_routing(models, monkeypatch, tmp_path, case):
    _, pm = models
    flags = {"flag off": {}, "disabled": {"ZGML_TPU_STACK_DECODE": "1",
                                          "ZGML_TPU_KERNELS_DISABLE": "stack_decode"}}
    _flags(monkeypatch, **flags.get(case, {"ZGML_TPU_STACK_DECODE": "1"}))
    batch, cache = (2, "bf16") if case == "batch 2" else (1, "int8" if case == "int8 cache" else
                                                           "bf16")
    tiers = _tiers(pm, batch, cache)
    assert "stack_decode" not in tiers
    if case in ("flag off", "disabled"):
        # the per-layer path, with the same counts as a model without the view
        plain = LlamaModel(pm.cfg, {k: v for k, v in pm.params.items() if k != "layers_stacked"})
        assert tiers == _tiers(plain) and tiers["attn_block"] == {"ref": 2 * CFG.n_layers}
