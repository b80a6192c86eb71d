"""K15, the tape-streamed whole-stack decode megacall: the port against the
JAX package on the config of tests/test_tapekernel.py (d 1024, 16/4 heads,
d_ff 1024, 2 layers, Q4_0), both loading one synthetic GGUF; the JAX kernel
runs in interpret mode. The JAX side keeps its weight scales as f32
(ZGML_TPU_SCALES=f32, set with monkeypatch), which holds the file's fp16
values exactly, as the port does: under f16 storage its build_tape converts
the FFN entries' int16 scale bits by value (tapekernel.py:178-179, 193; the
A and C entries go through scales_f32_np), so its tape would carry other
scales (ROADMAP.md, Reference weak spots). The port is held to the JAX
kernel's code, which rounds weights and operand rows to bf16 and quantizes
nothing to int8 (its module docstring and tests/test_tapekernel.py say
otherwise; ROADMAP.md, Reference weak spots).

  - enable_tape_decode() accepts and refuses where the JAX package's does (d
    1024 Q4_0; not d 512, Q8_0 or ZGML_TPU_ATTN_BLOCK=0 at load), with JAX's
    entry geometry, and no weight copied;
  - the port's bf16 weights (tapekernel.bf16_weight) are bit-equal to JAX's
    `_deq_rows(..., jnp.bfloat16)` on every entry of JAX's tape;
  - one decode step from a shared stacked bf16 cache, the port's plain
    version (through dispatch.tape_decode) against JAX's tape_decode_step:
    with ZGML_TPU_TAPE_BF16=0 x_out, k_cur and v_cur within 1e-5 * max|ref|;
    with bf16 operands within BF16_RTOL * max|ref| (measured below; a value
    the two sides sum in another order can round to bf16 on either side of a
    boundary) and the argmax of the logits equal;
  - with both views attached and both flags on, the tape runs;
  - decode_n equals a loop of step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zgml_tpu.ops import refs as jrefs
from zgml_tpu.ops import tapekernel as jtape

from zgml_tpu_torch.io.gguf import GGMLType
from zgml_tpu_torch.ops import dispatch, refs
from zgml_tpu_torch.ops.tapekernel import bf16_weight
from zgml_tpu_torch.runtime.engine import LlamaEngine
from zgml_tpu_torch.runtime.profile import global_profile

from test_torch_stackkernel import CFG as STACK_CFG, _both, _gguf, _no_copy, _shared_inputs
from test_torch_stackkernel import _flags as _stack_flags, check_step, jax_cache

torch.set_num_threads(1)

CFG = dataclasses.replace(STACK_CFG, d_model=1024, n_heads=16, n_kv_heads=4, d_ff=1024,
                          n_layers=2)
REL = 1e-5            # f32 operands on both sides
# bf16 operands: both sides round every operand row to bf16, and an element
# the two sum in another order can round to either neighbour. Measured here
# over pos 0, 1, 2, 3, 5, 37, 64, 100: at most positions no element flips and
# the outputs agree within 2.2e-7 of max|ref|; at pos 1 and 100 one flip in
# layer 0 moves x_out by 3.2e-3 and 2.3e-3 of max|ref| (k_cur and v_cur of
# layer 1 by up to 2.0e-3). The bound leaves 3x over the largest
BF16_RTOL = 1e-2
POS = (0, 1, 37)


def _flags(mp, **flags):
    _stack_flags(mp, ZGML_TPU_SCALES="f32", **flags)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = _gguf(tmp_path_factory.mktemp("torch_tape"), CFG)
    with pytest.MonkeyPatch.context() as mp:
        _flags(mp)
        jm, pm = _both(path)
        assert jm.enable_tape_decode() and pm.enable_tape_decode()
        assert pm.enable_stacked_decode()
    return jm, pm


@pytest.mark.parametrize("cfg,quant,attn_block", [
    (CFG, GGMLType.Q4_0, "1"), (STACK_CFG, GGMLType.Q4_0, "1"), (CFG, GGMLType.Q8_0, "1"),
    (CFG, GGMLType.Q4_0, "0")])
def test_enable_tape_decode_follows_jax(tmp_path, monkeypatch, cfg, quant, attn_block):
    _flags(monkeypatch, ZGML_TPU_ATTN_BLOCK=attn_block)
    jm, pm = _both(_gguf(tmp_path, cfg, quant))
    want = jm.enable_tape_decode()
    got = pm.enable_tape_decode()
    assert got == want == (cfg is CFG and quant == GGMLType.Q4_0 and attn_block == "1")
    assert ("layers_tape" in pm.params) == got
    if got:
        assert pm.params["layers_tape"].dims == jm.params["layers_tape"].dims
        _no_copy(pm.params["layers_tape"].stack, pm.params)


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint16)


def test_bf16_weights_bit_equal_jax_deq_rows(models, monkeypatch):
    """Every entry of JAX's tape through `_deq_rows(..., bf16)` against the
    port's bf16 weights of the same rows and columns (tapekernel.py:141-200
    for the entry layout); rows past the logical weight (padding) are 0."""
    jm, pm = models
    _flags(monkeypatch)
    tape = jm.params["layers_tape"]
    dp, n_qkv, fp, fp_pad, n_ac, n_c, n_gu, n_dn, nrow, dpg, epl, n_layers = tape.dims
    r, lanes, f = dp // 2, jtape.LANES, CFG.d_ff
    wt, st = np.asarray(tape.wtape), np.asarray(tape.stape)

    def zero_pad(m, rows, cols):
        out = np.zeros((rows, cols), np.float32)
        out[:m.shape[0], :m.shape[1]] = m
        return out

    for li, layer in enumerate(pm.params["layers"]):
        wqkv = bf16_weight(layer["wqkv"]).T.numpy()                       # [dp, n_qkv]
        wo = bf16_weight(layer["wo"]).T.numpy()                           # [dp, dp]
        gu = bf16_weight(layer["w_gate_up"]).T.numpy()
        gate, up = zero_pad(gu[:, :f], dp, fp), zero_pad(gu[:, f:], dp, fp)
        down = zero_pad(bf16_weight(layer["w_down"]).T.numpy(), fp_pad, dp)   # [fp_pad, dp]
        want = []                                  # (lo, hi) [R, LANES] per entry, in order
        for c in range(n_ac):
            cols = slice(c * lanes, (c + 1) * lanes)
            want.append((wqkv[:r, cols], wqkv[r:, cols]))
        for c in range(n_c):
            cols = slice(c * lanes, (c + 1) * lanes)
            want.append((wo[:r, cols], wo[r:, cols]))
        for c in range(n_gu):
            cols = slice(c * lanes, (c + 1) * lanes)
            for half in range(2):
                rows = slice(half * r, (half + 1) * r)
                want.append((gate[rows, cols], up[rows, cols]))
        for g in range(dpg):
            for j in range(nrow):
                rows = slice(j * r, (j + 1) * r)
                want.append((down[rows, g * lanes:(g + 1) * lanes],
                             down[rows, dp // 2 + g * lanes:dp // 2 + (g + 1) * lanes]))
        assert len(want) == epl
        for e, (wlo, whi) in enumerate(want):
            t = li * epl + e
            jlo, jhi = jtape._deq_rows(jnp.asarray(wt[t]), jnp.asarray(st[t]), r, 0, r,
                                       jnp.bfloat16)
            for got, ref in ((wlo, jlo), (whi, jhi)):
                got = torch.from_numpy(np.ascontiguousarray(got)).bfloat16().view(torch.int16)
                assert np.array_equal(got.numpy().view(np.uint16), _bits(ref)), (li, e)


def _step(jm, pm, monkeypatch, pos, bf16):
    """One step of both sides from a shared cache; returns (port outputs,
    JAX outputs (x_out [1, 1, d], k_cur, v_cur), caches)."""
    _flags(monkeypatch, ZGML_TPU_TAPE_DECODE="1", ZGML_TPU_TAPE_BF16="1" if bf16 else "0")
    # the JAX package reads ZGML_TPU_TAPE_BF16 while it traces the jitted
    # _tape_call (tapekernel.py:558), and a later call reuses that trace
    # whatever the flag says then; a fresh trace per call takes this one's
    jax.clear_caches()
    cfg, hd = pm.cfg, pm.cfg.head_dim
    x, ck, cv = _shared_inputs(np.random.default_rng(300 + pos), cfg, cfg.max_seq_len)
    cos, sin = jrefs.rope_cos_sin(jnp.asarray([pos]), hd, cfg.rope_base)
    seen = {}
    call = jtape._tape_call

    def spy(*args, **kw):
        seen["out"] = call(*args, **kw)
        return seen["out"]
    monkeypatch.setattr(jtape, "_tape_call", spy)
    jx, jck, jcv = jtape.tape_decode_step(jm.cfg, jm.params["layers_tape"], jnp.asarray(x),
                                          *jax_cache(ck, cv), pos, cos, sin)
    _, jk, jv = seen["out"]
    pcos, psin = refs.rope_cos_sin(torch.tensor([pos]), hd, cfg.rope_base)
    ck0, cv0 = ck.clone(), cv.clone()
    global_profile.reset()
    got = dispatch.tape_decode(torch.from_numpy(x), pm.params["layers_tape"], ck, cv,
                               torch.tensor([pos], dtype=torch.int32), pcos, psin)
    name = "tape_decode" if bf16 else "tape_decode_f32"
    assert global_profile.tier_summary() == {name: {"ref": 1}}
    return got, (jx, jk, jv), (jck, jcv), (ck, cv), (ck0, cv0)


@pytest.mark.parametrize("pos", POS)
def test_tape_decode_f32_step_matches_jax(models, monkeypatch, pos):
    jm, pm = models
    got, want, jcache, pcache, cache0 = _step(jm, pm, monkeypatch, pos, bf16=False)
    check_step(got, want, jcache, pcache, cache0, pos, REL)


@pytest.mark.parametrize("pos", POS)
def test_tape_decode_bf16_step_matches_jax(models, monkeypatch, pos):
    jm, pm = models
    got, want, jcache, pcache, cache0 = _step(jm, pm, monkeypatch, pos, bf16=True)
    errs = [float(np.max(np.abs(g.numpy() - np.asarray(w))) / np.max(np.abs(np.asarray(w))))
            for g, w in zip(got, want)]
    print(f"pos {pos}: x_out, k_cur, v_cur rel err {errs} (bound {BF16_RTOL})")
    check_step(got, want, jcache, pcache, cache0, pos, BF16_RTOL)
    logits = [pm.head(torch.as_tensor(np.asarray(o, np.float32)))[0, 0]
              for o in (got[0], want[0])]
    assert int(torch.argmax(logits[0])) == int(torch.argmax(logits[1]))


def test_tape_takes_precedence(models, monkeypatch):
    """Both views attached and both flags on: the tape runs (llama.py:753)."""
    _, pm = models
    _flags(monkeypatch, ZGML_TPU_TAPE_DECODE="1", ZGML_TPU_STACK_DECODE="1")
    global_profile.reset()
    eng = LlamaEngine(pm, prefill_chunk=16)
    eng.decode_n(torch.argmax(eng.prefill([1, 5, 9]), dim=-1), 3)
    tiers = global_profile.tier_summary()
    assert tiers["tape_decode"] == {"ref": 3} and "stack_decode" not in tiers
    assert "attn_block" not in tiers and "fused_ffn_norm" not in tiers


def test_tape_decode_n_equals_steps(models, monkeypatch):
    _, pm = models
    _flags(monkeypatch, ZGML_TPU_TAPE_DECODE="1")
    e1, e2 = LlamaEngine(pm), LlamaEngine(pm)
    e1.prefill([3, 1, 4])
    e2.prefill([3, 1, 4])
    toks = e1.decode_n([7], 4)[:, 0].tolist()
    got = [7]
    for _ in range(4):
        got.append(int(e2.step([got[-1]])[0][0]))
    assert toks == got[1:]
