"""The f32 KV cache's kernel modes on the card (skipped without one): K3 over
f32 K / V in both forms, K7 over the f32 cache, and the whole-stack decode
megacalls K14 / K15 over it.

    python -m pytest --noconftest -q tests/test_torch_kernels_f32cache.py

(tests/conftest.py imports jax, which the card's machine need not have.)

Bounds: K3's f32-K/V form within 1e-5 * max|o| of the plain version on the
same f32 K / V (f32 sums in another order); its bf16 form bit-equal to K3's
bf16 form run on k.bfloat16(), v.bfloat16() (the kernel rounds the staged
f32 rows to nearest even, as torch does, and takes that form's plan). K7
over the f32 cache within 1e-5 * max|out| of attn_block_ref (the int8 A
phase on the kernel's own activations), the written row bit-equal to k_cur
/ v_cur; every launch bit-equal to a second one. K14 and tape_decode_f32
over the f32 cache bit-equal to the per-layer chain K7 (f32-cache mode) +
K6d, every layer's row pos its own k_cur / v_cur and no other row changed;
K15 (bf16 operands) under its bf16-cache case's bounds (tests/
test_torch_kernels.py test_tape_decode_rms_error_and_two_launches); and
each of the three f32-cache modes, over an f32 cache that holds a bf16
cache's values, bit-equal to its bf16-cache launch (phase B reads the rows
below pos and attends the current token in f32 in either form).
"""
import numpy as np
import pytest
import torch

from zgml_tpu_torch.ops import dispatch, refs
from zgml_tpu_torch.ops.attention import flash_attention_cuda, flash_attention_ref
from zgml_tpu_torch.ops.layerkernel import attn_block_cuda, attn_block_ffn_ref, attn_block_ref
from zgml_tpu_torch.quant.packed import from_int8, from_nibbles
from zgml_tpu_torch.runtime.profile import global_profile

pytestmark = pytest.mark.gpu
REL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, rtol=REL):
    assert bool(torch.isfinite(got).all())
    err = float((got - want).abs().max())
    assert err <= rtol * float(want.abs().max()), err


# (B, Hq, Hkv, Tq, cache rows, S, d, kv_len, q_offset, kv_row): TinyLlama-1.1B
# and Llama-2-7B heads at q_offset 0 / 128 / 1408 (the last splits the prefix)
K3_CASES = [(1, 32, 4, 128, 22, 2048, 64, 128, 0, 5),
            (1, 32, 4, 128, 22, 2048, 64, 256, 128, 3),
            (1, 32, 4, 128, 22, 2048, 64, 1536, 1408, 1),
            (1, 32, 32, 128, 4, 2048, 128, 128, 0, 2),
            (1, 32, 32, 128, 4, 2048, 128, 1536, 1408, 1),
            (2, 4, 2, 40, 2, 64, 16, 64, 24, 0)]


@pytest.mark.parametrize("b,hq,hkv,tq,rows,s,d,kv_len,q_off,kv_row", K3_CASES)
def test_flash_attention_f32kv(cuda, b, hq, hkv, tq, rows, s, d, kv_len, q_off, kv_row):
    rng = np.random.default_rng(kv_len + d + kv_row)
    q = torch.from_numpy(rng.standard_normal((b, hq, tq, d)).astype(np.float32)).to(cuda)
    k, v = (torch.from_numpy(rng.standard_normal((rows, hkv, s, d)).astype(np.float32)).to(cuda)
            for _ in range(2))
    global_profile.reset()
    f32, f32b = (flash_attention_cuda(q, k, v, kv_len, q_off, kv_row) for _ in range(2))
    bf, bfb = (flash_attention_cuda(q, k, v, kv_len, q_off, kv_row, True) for _ in range(2))
    assert global_profile.tier_summary() == {"attention_f32kv": {"cuda": 2},
                                             "attention_bf16_f32kv": {"cuda": 2}}
    on_rounded = flash_attention_cuda(q, k.bfloat16(), v.bfloat16(), kv_len, q_off, kv_row, True)
    want = flash_attention_ref(q, k, v, kv_len, q_off, kv_row)
    torch.cuda.synchronize()
    _close(f32, want)
    assert torch.equal(f32, f32b) and torch.equal(bf, bfb)
    assert torch.equal(bf.view(torch.int32), on_rounded.view(torch.int32))


def _weight(rng, n, k, device, kind="q4_0"):
    d = rng.uniform(0.001, 0.02, (n, k // 32)).astype(np.float16)
    if kind == "q8_0":
        return from_int8(rng.integers(-127, 128, (n, k), dtype=np.int8), d / 16, device)
    return from_nibbles(rng.integers(0, 16, (n, k), dtype=np.uint8), d, device)


# (kind, int8 A phase, phase E, hq, hkv, hd, d_ff, S): TinyLlama-1.1B at both
# kinds, the int8 A phase at Llama-2-7B widths
K7_CASES = [("q4_0", False, False, 32, 4, 64, 5632, 2048),
            ("q8_0", False, False, 32, 4, 64, 5632, 2048),
            ("q4_0", False, True, 32, 4, 64, 5632, 2048),
            ("q4_0", True, False, 32, 32, 128, 11008, 2048),
            ("q4_0", True, True, 32, 32, 128, 11008, 2048)]


@pytest.mark.parametrize("pos", [0, 1, 200, 2047])
@pytest.mark.parametrize("kind,a_i8,e,hq,hkv,hd,f,s", K7_CASES)
def test_attn_block_f32_cache(cuda, kind, a_i8, e, hq, hkv, hd, f, s, pos):
    rng = np.random.default_rng(pos + hd + 7 * a_i8 + 3 * e)
    d, li = hq * hd, 1
    wqkv, wo = (_weight(rng, (hq + 2 * hkv) * hd, d, cuda, kind),
                _weight(rng, d, hq * hd, cuda, kind))
    ffn = None
    if e:
        g2 = torch.from_numpy((1 + 0.1 * rng.standard_normal(d)).astype(np.float32)).to(cuda)
        ffn = (g2, _weight(rng, 2 * f, d, cuda), _weight(rng, d, f, cuda))
    g1 = torch.from_numpy((1 + 0.1 * rng.standard_normal(d)).astype(np.float32)).to(cuda)
    x = torch.from_numpy(rng.standard_normal((1, 1, d)).astype(np.float32)).to(cuda)
    ck, cv = (torch.from_numpy(rng.standard_normal((2, 1, hkv, s, hd)).astype(np.float32))
              .to(cuda) for _ in range(2))
    cos, sin = refs.rope_cos_sin(torch.tensor([pos], device=cuda), hd)
    pos_t = torch.tensor([pos], dtype=torch.int32, device=cuda)
    ck1, cv1, ck2, cv2 = ck.clone(), cv.clone(), ck.clone(), cv.clone()
    act = ((torch.empty(d, dtype=torch.int8, device=cuda),
            torch.empty(d // 32, dtype=torch.float32, device=cuda)) if a_i8 else None)
    global_profile.reset()
    got = attn_block_cuda(x, g1, wqkv, wo, ck1, cv1, li, pos_t, cos, sin, hq, hkv, 1e-5, a_i8,
                          act_out=act, ffn=ffn)
    again = attn_block_cuda(x, g1, wqkv, wo, ck2, cv2, li, pos_t, cos, sin, hq, hkv, 1e-5, a_i8,
                            ffn=ffn)
    name = "attn_block" + ("_i8" if a_i8 else "") + "_f32kv" + ("_ffn" if e else "") + \
        ("_q8" if kind == "q8_0" else "")
    assert global_profile.tier_summary() == {name: {"cuda": 2}}
    if e:
        want = attn_block_ffn_ref(x, g1, wqkv, wo, ck, cv, li, pos, cos, sin, hq, hkv, 1e-5,
                                  ffn, a_i8, act)
    else:
        want = attn_block_ref(x, g1, wqkv, wo, ck, cv, li, pos, cos, sin, hq, hkv, 1e-5, a_i8,
                              act)
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, again):
        _close(a, b)
        assert torch.equal(a, c)
    assert torch.equal(ck1, ck2) and torch.equal(cv1, cv2)
    assert torch.equal(ck1[li, 0, :, pos], got[1][0, :, 0])        # the row: k_cur as it is
    assert torch.equal(cv1[li, 0, :, pos], got[2][0, :, 0])
    rest = torch.ones(s, dtype=torch.bool, device=cuda)
    rest[pos] = False
    assert torch.equal(ck1[:, :, :, rest], ck[:, :, :, rest])      # nothing else written


def test_dispatch_routes_the_f32_cache(cuda, monkeypatch):
    """dispatch sends f32 K / V to K3's f32-K/V forms (by the prefill flag)
    and an f32 cache to K7's f32-cache mode."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, 8, 16, 64)).astype(np.float32)).to(cuda)
    k, v = (torch.from_numpy(rng.standard_normal((1, 2, 64, 64)).astype(np.float32)).to(cuda)
            for _ in range(2))
    global_profile.reset()
    monkeypatch.setenv("ZGML_TPU_PREFILL_BF16", "1")
    dispatch.flash_attention(q, k, v, 16)
    monkeypatch.setenv("ZGML_TPU_PREFILL_BF16", "0")
    dispatch.flash_attention(q, k, v, 16)
    hq, hkv, hd = 8, 2, 64
    d = hq * hd
    wqkv, wo = _weight(rng, (hq + 2 * hkv) * hd, d, cuda), _weight(rng, d, hq * hd, cuda)
    ck, cv = (torch.zeros((1, 1, hkv, 64, hd), device=cuda) for _ in range(2))
    cos, sin = refs.rope_cos_sin(torch.tensor([5], device=cuda), hd)
    dispatch.attn_block(torch.ones((1, 1, d), device=cuda), torch.ones(d, device=cuda), wqkv, wo,
                        ck, cv, 0, torch.tensor([5], dtype=torch.int32, device=cuda), cos, sin,
                        hq, hkv, 1e-5)
    torch.cuda.synchronize()
    assert global_profile.tier_summary() == {"attention_bf16_f32kv": {"cuda": 1},
                                             "attention_f32kv": {"cuda": 1},
                                             "attn_block_f32kv": {"cuda": 1}}


# (L, hq, hkv, hd, f, S, pos): TinyLlama-1.1B and Llama-2-7B widths, pos 0
STACK_CASES = [(3, 32, 4, 64, 5632, 2048, 300), (2, 32, 32, 128, 11008, 512, 257),
               (2, 8, 2, 64, 768, 64, 0)]


def _stack_inputs(rng, n_layers, hq, hkv, hd, f, s, pos, device):
    from test_torch_kernels import _stack
    stack = _stack(rng, n_layers, hq, hkv, hd, f, device)
    x = torch.from_numpy(rng.standard_normal((1, 1, hq * hd)).astype(np.float32)).to(device)
    ck, cv = (torch.from_numpy(rng.standard_normal((n_layers, 1, hkv, s, hd)).astype(np.float32))
              .to(device) for _ in range(2))
    cos, sin = refs.rope_cos_sin(torch.tensor([pos], device=device), hd)
    return stack, x, ck, cv, cos, sin, torch.tensor([pos], dtype=torch.int32, device=device)


@pytest.mark.parametrize("mode", ("stack", "tape_f32"))
@pytest.mark.parametrize("n_layers,hq,hkv,hd,f,s,pos", STACK_CASES)
def test_stack_decode_f32_cache_is_the_layer_chain(cuda, mode, n_layers, hq, hkv, hd, f, s, pos):
    from zgml_tpu_torch.ops.stackkernel import layer_chain, stacked_decode_cuda
    from zgml_tpu_torch.ops.tapekernel import Tape, tape_decode_cuda
    stack, x, ck, cv, cos, sin, pos_t = _stack_inputs(np.random.default_rng(pos + n_layers),
                                                      n_layers, hq, hkv, hd, f, s, pos, cuda)

    def run(kc, vc):
        if mode == "stack":
            return stacked_decode_cuda(x, stack, kc, vc, pos_t, cos, sin)
        return tape_decode_cuda(x, Tape(stack, ()), kc, vc, pos_t, cos, sin, bf16=False)
    ck1, cv1, ck2, cv2 = ck.clone(), cv.clone(), ck.clone(), cv.clone()
    global_profile.reset()
    got, again = run(ck1, cv1), run(ck.clone(), cv.clone())
    assert global_profile.tier_summary() == {
        "stack_decode_f32kv" if mode == "stack" else "tape_decode_f32_f32kv": {"cuda": 2}}
    want = layer_chain(x, stack, ck2, cv2, pos_t, cos, sin)
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, again):
        assert torch.equal(a.reshape(b.shape), b) and torch.equal(a, c)
    assert torch.equal(ck1, ck2) and torch.equal(cv1, cv2)
    rows = torch.arange(s, device=cuda) != pos
    assert torch.equal(ck1[:, 0, :, pos], got[1]) and torch.equal(cv1[:, 0, :, pos], got[2])
    assert torch.equal(ck1[:, :, :, rows], ck[:, :, :, rows])
    assert torch.equal(cv1[:, :, :, rows], cv[:, :, :, rows])


@pytest.mark.parametrize("n_layers,hq,hkv,hd,f,s,pos", STACK_CASES)
def test_tape_decode_f32_cache(cuda, n_layers, hq, hkv, hd, f, s, pos):
    from zgml_tpu_torch.ops.stackkernel import layer_chain, stacked_decode_f64
    from zgml_tpu_torch.ops.tapekernel import Tape, bf16_weight, tape_decode_cuda, tape_decode_ref
    stack, x, ck, cv, cos, sin, pos_t = _stack_inputs(np.random.default_rng(pos + 7 * n_layers),
                                                      n_layers, hq, hkv, hd, f, s, pos, cuda)
    tape = Tape(stack, ())
    global_profile.reset()
    ck1 = ck.clone()
    got = tape_decode_cuda(x, tape, ck1, cv.clone(), pos_t, cos, sin)
    again = tape_decode_cuda(x, tape, ck.clone(), cv.clone(), pos_t, cos, sin)
    assert global_profile.tier_summary() == {"tape_decode_f32kv": {"cuda": 2}}
    want = tape_decode_ref(x, tape, ck.clone(), cv.clone(), pos, cos, sin)
    chain = layer_chain(x, stack, ck.clone(), cv.clone(), pos_t, cos, sin)
    exact = stacked_decode_f64(x, stack, ck, cv, pos, cos, sin, bf16_weight)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(ck1[:, 0, :, pos], got[1])
    flat = [torch.cat([t.reshape(-1) for t in out]).double() for out in (got, want, chain)]

    def rms(a, b):
        return float(torch.sqrt(torch.mean((a - b) ** 2)))
    assert rms(flat[0], exact) <= 2.0 * rms(flat[1], exact)
    assert rms(flat[0], flat[1]) <= 0.5 * rms(flat[2], flat[1])


@pytest.mark.parametrize("mode", ("stack", "tape", "tape_f32"))
@pytest.mark.parametrize("n_layers,hq,hkv,hd,f,s,pos", STACK_CASES)
def test_megacalls_over_bf16_values_in_an_f32_cache_give_the_bf16_cache_bits(
        cuda, mode, n_layers, hq, hkv, hd, f, s, pos):
    from zgml_tpu_torch.ops.stackkernel import stacked_decode_cuda
    from zgml_tpu_torch.ops.tapekernel import Tape, tape_decode_cuda
    stack, x, ck, cv, cos, sin, pos_t = _stack_inputs(np.random.default_rng(pos + 3 * n_layers),
                                                      n_layers, hq, hkv, hd, f, s, pos, cuda)
    kb, vb = ck.to(torch.bfloat16), cv.to(torch.bfloat16)

    def run(kc, vc):
        if mode == "stack":
            return stacked_decode_cuda(x, stack, kc, vc, pos_t, cos, sin)
        return tape_decode_cuda(x, Tape(stack, ()), kc, vc, pos_t, cos, sin,
                                bf16=mode == "tape")
    kf, vf = kb.float(), vb.float()
    base, got = run(kb.clone(), vb.clone()), run(kf, vf)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, base))
    rows = torch.arange(s, device=cuda) != pos
    for c, c_b, cur in ((kf, kb, got[1]), (vf, vb, got[2])):
        assert torch.equal(c[:, 0, :, pos], cur)
        assert torch.equal(c[:, :, :, rows], c_b[:, :, :, rows].float())
