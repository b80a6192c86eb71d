"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA device and skips without one (the kernels have no
CPU mode). The file imports neither jax nor zgml_tpu, so it also runs on a GPU
machine without JAX, where tests/conftest.py (which imports jax) is skipped:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

The weight kernels run at both kinds, Q4_0 and Q8_0. Tolerances: K2 rtol
1e-5 / atol 1e-4*sqrt(K) and K3/K4 1e-5, since kernel and plain version both
compute in f32 and differ only in the order of the sums; K1, K6 and K7
1e-5 * max|out| for the same reason (K1's int8 block dots are exact on both
sides, and its quantized activations must be bit-equal); K5's id must equal
argmax of K1's output on the card exactly. The i8a modes (K7-i8, K6c)
quantize a row they norm themselves, which the plain version norms summing
in another order: the plain version runs on the kernel's own activations
(act_out / act), and those may differ from the plain pre-pass by one level in
at most 1% of the values.
"""
import numpy as np
import pytest
import torch

from zgml_tpu_torch.ops import dispatch, refs
from zgml_tpu_torch.ops.attention import (decode_attention_cuda, decode_attention_ref,
                                          flash_attention_cuda, flash_attention_ref)
from zgml_tpu_torch.ops.ffn import (fused_ffn_cuda, fused_ffn_norm_cuda, fused_ffn_norm_ref,
                                    fused_ffn_ref)
from zgml_tpu_torch.ops.layerkernel import attn_block_cuda, attn_block_ref
from zgml_tpu_torch.ops.qmatmul import (greedy_cuda, qmatmul_cuda, qmatmul_i8_cuda,
                                        qmatmul_i8_ref, qmatmul_ref, quantize_act_cuda,
                                        quantize_act_ref, rmsnorm_quantize_ref)
from zgml_tpu_torch.quant.packed import PackedWeight, from_int8, from_nibbles
from zgml_tpu_torch.runtime.profile import global_profile

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


KINDS = ["q4_0", "q8_0"]


def _weight(rng, n, k, device, kind="q4_0"):
    d = rng.uniform(0.001, 0.02, (n, k // 32)).astype(np.float16)
    if kind == "q8_0":
        return from_int8(rng.integers(-127, 128, (n, k), dtype=np.int8), d / 16, device)
    return from_nibbles(rng.integers(0, 16, (n, k), dtype=np.uint8), d, device)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m,n,k", [(1, 2560, 2048), (3, 300, 576), (4, 64, 5632),
                                   (5, 96, 64), (128, 2048, 2048), (77, 1000, 512)])
def test_q4_matmul(cuda, m, n, k, kind):
    rng = np.random.default_rng(m * 7 + n)
    w = _weight(rng, n, k, cuda, kind)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(cuda)
    got = qmatmul_cuda(x, w)
    want = qmatmul_ref(x, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4 * np.sqrt(k))


def _qkv(rng, b, hq, hkv, tq, rows, s, d, device):
    q = torch.from_numpy(rng.standard_normal((b, hq, tq, d)).astype(np.float32)).to(device)
    k = torch.from_numpy(rng.standard_normal((rows, hkv, s, d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((rows, hkv, s, d)).astype(np.float32))
    return q, k.to(device, torch.bfloat16), v.to(device, torch.bfloat16)


@pytest.mark.parametrize("b,hq,hkv,tq,rows,s,d,kv_len,q_off,kv_row", [
    (1, 32, 4, 128, 22, 2048, 64, 128, 0, 5),
    (1, 32, 4, 128, 2, 2048, 64, 300, 256, 1),     # ragged last chunk
    (2, 4, 4, 16, 2, 64, 16, 64, 48, 0),
    (1, 8, 2, 40, 1, 128, 128, 77, 37, 0),
    (1, 8, 2, 8, 1, 64, 32, 0, 0, 0),              # no live key -> 0
])
def test_flash_attention(cuda, b, hq, hkv, tq, rows, s, d, kv_len, q_off, kv_row):
    q, k, v = _qkv(np.random.default_rng(kv_len + d), b, hq, hkv, tq, rows, s, d, cuda)
    got = flash_attention_cuda(q, k, v, kv_len, q_off, kv_row)
    want = flash_attention_ref(q, k, v, kv_len, q_off, kv_row)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,hq,hkv,rows,s,d,kv_len,kv_row", [
    (1, 32, 4, 22, 2048, 64, [1], 7),
    (1, 32, 4, 22, 2048, 64, [200], 0),
    (1, 32, 4, 1, 2048, 64, [2047], 0),
    (2, 8, 2, 3, 256, 128, [129, 5], 1),
    (2, 4, 4, 2, 64, 16, [0, 64], 0),
])
def test_decode_attention(cuda, b, hq, hkv, rows, s, d, kv_len, kv_row):
    q, k, v = _qkv(np.random.default_rng(sum(kv_len) + d), b, hq, hkv, 1, rows, s, d, cuda)
    lens = torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    got = decode_attention_cuda(q, k, v, lens, kv_row)
    want = decode_attention_ref(q, k, v, lens, kv_row)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_dispatch_counts_kernel_launches(cuda, monkeypatch):
    monkeypatch.setenv("ZGML_TPU_I8DOT", "0")       # K2 at every M
    rng = np.random.default_rng(0)
    w = _weight(rng, 64, 64, cuda)
    x = torch.ones(2, 64, device=cuda)
    global_profile.reset()
    dispatch.qmatmul(x, w)
    with dispatch.force_ref():
        dispatch.qmatmul(x, w)
    assert global_profile.tier_summary()["qmatmul"] == {"cuda": 1, "ref": 1}


def test_wrappers_refuse_bad_inputs(cuda):
    w = PackedWeight(8, 32, torch.zeros(8, 16, dtype=torch.uint8, device=cuda),
                     torch.zeros(8, 1, dtype=torch.float16, device=cuda))
    with pytest.raises(ValueError, match="float32"):
        qmatmul_cuda(torch.zeros(1, 32, device=cuda, dtype=torch.float16), w)
    with pytest.raises(ValueError, match="contiguous"):
        qmatmul_cuda(torch.zeros(32, 2, device=cuda).T, w)
    q = torch.zeros(1, 2, 4, 16, device=cuda)
    kv = torch.zeros(1, 1, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        flash_attention_cuda(q, kv, kv, 4)


def _close(got, want):
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m,n,k", [(1, 2560, 2048), (8, 2048, 5632), (32, 11264, 2048),
                                   (5, 96, 64), (3, 300, 576)])
def test_q4_matmul_i8(cuda, m, n, k, kind):
    rng = np.random.default_rng(m * 11 + n)
    w = _weight(rng, n, k, cuda, kind)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(cuda)
    x[0, :32] = 0.0
    xq, xs = quantize_act_cuda(x)
    rq, rs = quantize_act_ref(x)
    got = qmatmul_i8_cuda(x, w)
    want = qmatmul_i8_ref(x, w)
    torch.cuda.synchronize()
    assert torch.equal(xq, rq) and torch.equal(xs.view(torch.int32), rs.view(torch.int32))
    _close(got, want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,k,seed", [(32000, 2048, 0), (32000, 2048, 1), (96, 64, 2),
                                      (1000, 512, 3)])
def test_q4_greedy(cuda, n, k, seed, kind):
    rng = np.random.default_rng(seed)
    w = _weight(rng, n, k, cuda, kind)
    x = torch.from_numpy(rng.standard_normal((1, k)).astype(np.float32)).to(cuda)
    tok = greedy_cuda(x, w)
    y = qmatmul_i8_cuda(x, w)
    torch.cuda.synchronize()
    assert tok.dtype == torch.int64 and int(tok[0]) == int(torch.argmax(y[0]))


def test_q4_greedy_first_index_on_ties(cuda):
    for w in (from_nibbles(np.full((64, 64), 9, np.uint8), np.full((64, 2), 0.5, np.float16),
                           cuda),
              from_int8(np.full((64, 64), 3, np.int8), np.full((64, 2), 0.5, np.float16), cuda)):
        tok = greedy_cuda(torch.ones(1, 64, device=cuda), w)     # every row equal
        torch.cuda.synchronize()
        assert int(tok[0]) == 0


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("d,f,m", [(2048, 5632, 1), (512, 320, 3), (2048, 5632, 32),
                                   (512, 1024, 16)])
def test_fused_ffn_norm(cuda, d, f, m, kind):
    rng = np.random.default_rng(d + f + m)
    gu, wd = _weight(rng, 2 * f, d, cuda, kind), _weight(rng, d, f, cuda, kind)
    g = torch.from_numpy((1 + 0.1 * rng.standard_normal(d)).astype(np.float32)).to(cuda)
    x = torch.from_numpy(rng.standard_normal((m, 1, d)).astype(np.float32)).to(cuda)
    got = fused_ffn_norm_cuda(x, g, gu, wd, 1e-5)
    want = fused_ffn_norm_ref(x, g, gu, wd, 1e-5)
    torch.cuda.synchronize()
    _close(got, want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("hq,hkv,hd,s,pos,li", [(32, 4, 64, 2048, 0, 3), (32, 4, 64, 2048, 1, 21),
                                                (32, 4, 64, 2048, 200, 5),
                                                (32, 4, 64, 2048, 2047, 1),
                                                (8, 2, 32, 96, 37, 1), (8, 8, 128, 256, 130, 0),
                                                # every other compiled head dim
                                                (4, 2, 96, 128, 50, 1), (4, 4, 160, 128, 0, 0),
                                                (4, 2, 192, 128, 1, 0), (2, 1, 224, 64, 63, 1),
                                                (8, 2, 256, 256, 130, 1)])
def test_attn_block(cuda, hq, hkv, hd, s, pos, li, kind):
    rng = np.random.default_rng(pos + hd)
    d, L = hq * hd, max(li + 1, 2)
    wqkv = _weight(rng, (hq + 2 * hkv) * hd, d, cuda, kind)
    wo = _weight(rng, d, hq * hd, cuda, kind)
    g = torch.from_numpy((1 + 0.1 * rng.standard_normal(d)).astype(np.float32)).to(cuda)
    x = torch.from_numpy(rng.standard_normal((1, 1, d)).astype(np.float32)).to(cuda)
    ck = torch.from_numpy(rng.standard_normal((L, 1, hkv, s, hd)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    cv = torch.from_numpy(rng.standard_normal((L, 1, hkv, s, hd)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    cos, sin = refs.rope_cos_sin(torch.tensor([pos], device=cuda), hd)
    pos_t = torch.tensor([pos], dtype=torch.int32, device=cuda)
    ck_r, cv_r = ck.clone(), cv.clone()
    got = attn_block_cuda(x, g, wqkv, wo, ck, cv, li, pos_t, cos, sin, hq, hkv, 1e-5)
    want = attn_block_ref(x, g, wqkv, wo, ck_r, cv_r, li, pos, cos, sin, hq, hkv, 1e-5)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        _close(a, b)
    # the kernel's cache row is its own k_cur / v_cur rounded to bf16; the rest untouched
    assert torch.equal(ck[li, 0, :, pos], got[1][0, :, 0].to(torch.bfloat16))
    assert torch.equal(cv[li, 0, :, pos], got[2][0, :, 0].to(torch.bfloat16))
    rows = torch.arange(s, device=cuda) != pos
    assert torch.equal(ck[:, :, :, rows], ck_r[:, :, :, rows])
    assert torch.equal(cv[:, :, :, rows], cv_r[:, :, :, rows])


def test_dispatch_counts_each_kernel(cuda):
    """Each kernel has its own counter; force_ref() keeps the path and counts
    the plain versions under the same names."""
    rng = np.random.default_rng(1)
    w = _weight(rng, 64, 64, cuda)
    x = torch.ones(1, 64, device=cuda)
    global_profile.reset()
    dispatch.qmatmul(x, w)
    dispatch.qmatmul_greedy(x, w)
    dispatch.qmatmul(torch.ones(33, 64, device=cuda), w)
    with dispatch.force_ref():
        dispatch.qmatmul(x, w)
        dispatch.qmatmul_greedy(x, w)
    assert global_profile.tier_summary() == {"qmatmul": {"cuda": 1},
                                             "qmatmul_i8": {"cuda": 1, "ref": 1},
                                             "qmatmul_greedy": {"cuda": 1, "ref": 1}}
    # a Q8_0 weight counts under the _q8 names
    w8 = _weight(rng, 64, 64, cuda, "q8_0")
    global_profile.reset()
    dispatch.qmatmul(x, w8)
    dispatch.qmatmul_greedy(x, w8)
    dispatch.qmatmul(torch.ones(33, 64, device=cuda), w8)
    assert global_profile.tier_summary() == {"qmatmul_q8": {"cuda": 1},
                                             "qmatmul_i8_q8": {"cuda": 1},
                                             "qmatmul_greedy_q8": {"cuda": 1}}


def _act_buffers(m, d, device):
    return (torch.empty((m, d), dtype=torch.int8, device=device),
            torch.empty((m, d // 32), dtype=torch.float32, device=device))


def _check_own_activations(act, x, g):
    """The kernel's int8 activations against the plain pre-pass of the same
    rows: a level may land one apart where the two norms round apart."""
    rq, rs = rmsnorm_quantize_ref(x, g, 1e-5)
    xq, xs = act[0].reshape(rq.shape), act[1].reshape(rs.shape)
    diff = (xq.to(torch.int16) - rq.to(torch.int16)).abs()
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) <= 0.01
    torch.testing.assert_close(xs, rs, rtol=1e-6, atol=0)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("hq,hkv,hd,s,pos,li", [(32, 32, 128, 2048, 0, 1),
                                                (32, 32, 128, 2048, 1, 1),
                                                (32, 32, 128, 2048, 200, 0),
                                                (32, 32, 128, 2048, 2047, 1),
                                                (32, 4, 64, 256, 130, 1), (8, 2, 32, 96, 37, 1)])
def test_attn_block_i8(cuda, hq, hkv, hd, s, pos, li, kind):
    """K7's int8 A phase (Llama-2-7B's MHA head_dim 128, and GQA)."""
    rng = np.random.default_rng(pos + hd + 1)
    d, L = hq * hd, max(li + 1, 2)
    wqkv = _weight(rng, (hq + 2 * hkv) * hd, d, cuda, kind)
    wo = _weight(rng, d, hq * hd, cuda, kind)
    g = torch.from_numpy((1 + 0.1 * rng.standard_normal(d)).astype(np.float32)).to(cuda)
    x = torch.from_numpy(rng.standard_normal((1, 1, d)).astype(np.float32)).to(cuda)
    ck = torch.from_numpy(rng.standard_normal((L, 1, hkv, s, hd)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    cv = torch.from_numpy(rng.standard_normal((L, 1, hkv, s, hd)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    cos, sin = refs.rope_cos_sin(torch.tensor([pos], device=cuda), hd)
    pos_t = torch.tensor([pos], dtype=torch.int32, device=cuda)
    ck_r, cv_r = ck.clone(), cv.clone()
    act = _act_buffers(1, d, cuda)
    global_profile.reset()
    got = attn_block_cuda(x, g, wqkv, wo, ck, cv, li, pos_t, cos, sin, hq, hkv, 1e-5,
                          a_i8=True, act_out=act)
    want = attn_block_ref(x, g, wqkv, wo, ck_r, cv_r, li, pos, cos, sin, hq, hkv, 1e-5,
                          a_i8=True, act=act)
    torch.cuda.synchronize()
    name = "attn_block_i8" if kind == "q4_0" else "attn_block_i8_q8"
    assert global_profile.tier_summary() == {name: {"cuda": 1}}
    for a, b in zip(got, want):
        _close(a, b)
    _check_own_activations(act, x, g)
    assert torch.equal(ck[li, 0, :, pos], got[1][0, :, 0].to(torch.bfloat16))
    rows = torch.arange(s, device=cuda) != pos
    assert torch.equal(ck[:, :, :, rows], ck_r[:, :, :, rows])


@pytest.mark.parametrize("d,f,m", [(4096, 11008, 1), (4096, 11008, 8), (4096, 11008, 32),
                                   (512, 320, 3)])
def test_fused_ffn_norm_i8(cuda, d, f, m):
    """K6c: int8 gate|up on the kernel's own activations, f32 down."""
    rng = np.random.default_rng(d + f + m + 1)
    gu, wd = _weight(rng, 2 * f, d, cuda), _weight(rng, d, f, cuda)
    g = torch.from_numpy((1 + 0.1 * rng.standard_normal(d)).astype(np.float32)).to(cuda)
    x = torch.from_numpy(rng.standard_normal((m, 1, d)).astype(np.float32)).to(cuda)
    act = _act_buffers(m, d, cuda)
    global_profile.reset()
    got = fused_ffn_norm_cuda(x, g, gu, wd, 1e-5, a_i8=True, act_out=act)
    want = fused_ffn_norm_ref(x, g, gu, wd, 1e-5, a_i8=True, act=act)
    torch.cuda.synchronize()
    assert global_profile.tier_summary() == {"fused_ffn_norm_i8": {"cuda": 1}}
    _close(got, want)
    _check_own_activations(act, x, g)


@pytest.mark.parametrize("d,f,m", [(4096, 11008, 1), (4096, 11008, 7), (4096, 11008, 32),
                                   (2048, 5632, 7), (2048, 5632, 16), (512, 320, 3)])
def test_fused_ffn(cuda, d, f, m):
    """K6b: every weight block read once for all M rows of a normed h."""
    rng = np.random.default_rng(d + f + m + 2)
    gu, wd = _weight(rng, 2 * f, d, cuda), _weight(rng, d, f, cuda)
    h = torch.from_numpy(rng.standard_normal((1, m, d)).astype(np.float32)).to(cuda)
    global_profile.reset()
    got = fused_ffn_cuda(h, gu, wd)
    want = fused_ffn_ref(h, gu, wd)
    torch.cuda.synchronize()
    assert global_profile.tier_summary() == {"fused_ffn": {"cuda": 1}}
    _close(got, want)
