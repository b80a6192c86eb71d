"""The f32 KV cache's kernel modes on the card (skipped without one): K3 over
f32 K / V in both forms and K7 over the f32 cache.

    python -m pytest --noconftest -q tests/test_torch_kernels_f32cache.py

(tests/conftest.py imports jax, which the card's machine need not have.)

Bounds: K3's f32-K/V form within 1e-5 * max|o| of the plain version on the
same f32 K / V (f32 sums in another order); its bf16 form bit-equal to K3's
bf16 form run on k.bfloat16(), v.bfloat16() (the kernel rounds the staged
f32 rows to nearest even, as torch does, and takes that form's plan). K7
over the f32 cache within 1e-5 * max|out| of attn_block_ref (the int8 A
phase on the kernel's own activations), the written row bit-equal to k_cur
/ v_cur; every launch bit-equal to a second one.
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
