"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA device and skips without one (the kernels have no
CPU mode). The file imports neither jax nor zgml_tpu, so it also runs on a GPU
machine without JAX, where tests/conftest.py (which imports jax) is skipped:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

The weight kernels run at both kinds, Q4_0 and Q8_0. Tolerances: K2 rtol
1e-5 / atol 1e-4*sqrt(K) and K3/K4 1e-5, since kernel and plain version both
compute in f32 and differ only in the order of the sums (K2 above 4 rows
takes x as two TF32 parts against exact levels, one fresh accumulator per
quant block: bit-equal over two launches, its rms error against float64 at
most 2x the plain version's; K3 / K9 / K10f take
q and p as two TF32 parts on the tensor cores, which leaves at most 2^-22 of
each: f32's class, tests/test_torch_flash_split.py); K1, K6 and K7
1e-5 * max|out| for the same reason (K1's int8 block dots are exact on both
sides, and its quantized activations must be bit-equal); K5's id must equal
argmax of K1's output on the card exactly. The i8a modes (K7-i8, K6c)
quantize a row they norm themselves, which the plain version norms summing
in another order: the plain version runs on the kernel's own activations
(act_out / act), and those may differ from the plain pre-pass by one level in
at most 1% of the values. The int8-cache kernels (K8, K9, K7's kv8 mode) hold
1e-5 against their plain versions on the same int8 cache (K8 quantizes q in
the kernel bit-equal to the plain quantize_columns; its ZGML_TPU_ATTN_I8PV
mode against the plain version of its split plan, or the flips a few-ulp
move of the score scale causes there; K7-kv8's plain version
runs on the kernel's own quantized q, q8_out / q8, whose levels may sit one
apart from the plain ones), and K7-kv8's cache row pos is quantize_columns
of the kernel's own k_cur / v_cur bit for bit. Training: K10f's O equals K3's
bit for bit and its LSE the plain one within 1e-5 * max; K10dq within 1e-5 *
max|dQ|, its rms error against float64 at most 2x the plain version's
(split-TF32 tensor cores, tests/test_torch_flash_bwd_split.py); K10dkv's
bf16 dK / dV within one bf16 ulp per element of the plain versions on the
same inputs; both bit-equal over two launches (fixed split plans); K11 within K2's bound with N in K's place,
bit-equal over two launches, its rms error against float64 at most 2x that
of cuBLAS f32 (tests/test_torch_qmatmul_split.py emulates its arithmetic).
The whole-stack megacalls K14 / K15 hold 1e-5 * max|out| once per layer with
f32 operands (each layer hands its summation-order difference on) and 1e-2
with K15's bf16 operands (an operand the two sum in another order rounds to
either bf16 neighbour; tests/test_torch_tapekernel.py).
"""
import numpy as np
import pytest
import torch

from zgml_tpu_torch.ops import dispatch, refs
from zgml_tpu_torch.ops.attention import (decode_attention_cuda, decode_attention_q8_cuda,
                                          decode_attention_q8_ref, decode_attention_ref,
                                          decode_q8_splits,
                                          flash_attention_cuda, flash_attention_q8_cuda,
                                          flash_attention_q8_ref, flash_attention_ref)
from zgml_tpu_torch.ops.ffn import (fused_ffn_cuda, fused_ffn_norm_cuda, fused_ffn_norm_ref,
                                    fused_ffn_ref)
from zgml_tpu_torch.ops.layerkernel import attn_block_cuda, attn_block_ref, qkv_ref
from zgml_tpu_torch.ops.qmatmul import (greedy_cuda, qmatmul_cuda, qmatmul_i8_cuda,
                                        qmatmul_i8_ref, qmatmul_ref, quantize_act_cuda,
                                        quantize_act_ref, rmsnorm_quantize_ref)
from zgml_tpu_torch.quant.kv_cache import quantize_columns
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
                                   (5, 96, 64), (128, 2048, 2048), (77, 1000, 512),
                                   (7, 2560, 2048), (33, 1000, 576), (512, 2048, 2048),
                                   (512, 333, 5632), (130, 77, 96), (128, 32000, 2048)])
def test_q4_matmul(cuda, m, n, k, kind):
    """K2 against x @ dequant(W).T; above GEMV_MAX_M rows (split-TF32
    tensor cores, tests/test_torch_qmatmul_fwd_split.py) also bit-equal over
    two launches (a fixed split, no atomics) and its rms error against
    float64 at most 2x that of the plain version (cuBLAS f32)."""
    from zgml_tpu_torch.ops.qmatmul import GEMV_MAX_M
    rng = np.random.default_rng(m * 7 + n)
    w = _weight(rng, n, k, cuda, kind)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(cuda)
    got, again = qmatmul_cuda(x, w), qmatmul_cuda(x, w)
    want = qmatmul_ref(x, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4 * np.sqrt(k))
    assert torch.equal(got, again)
    if m > GEMV_MAX_M:
        exact = x.double() @ w.dequant().double().T

        def rms(y):
            return float((y.double() - exact).square().mean().sqrt())
        assert rms(got) <= 2 * rms(want), (rms(got), rms(want))


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
    # the prefix split across blocks (flash_split_plan) and merged
    (1, 32, 4, 128, 22, 2048, 64, 1536, 1408, 3),  # TinyLlama chunk 12 of a 1536 prompt
    (1, 32, 32, 128, 4, 2048, 128, 1536, 1408, 1), # Llama-2-7B chunk 12, head_dim 128
    (1, 32, 4, 128, 2, 2048, 64, 1000, 900, 1),    # kv_len ends inside a key tile
    (1, 8, 2, 37, 1, 256, 64, 200, 163, 0),        # Tq not a multiple of 16
    (1, 32, 4, 40, 1, 512, 64, 400, 360, 0),       # n_rep 8 with Tq 40
    (2, 32, 4, 128, 6, 2048, 64, 1536, 1408, 2),   # B 2 through kv_row
    (1, 32, 32, 128, 1, 256, 128, 128, 0, 0),      # split 2's keys all masked for early rows
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
    # batch 4 with a row of no key, at every head dim (TinyLlama-1.1B's heads at 64)
    (4, 32, 4, 88, 2048, 64, [0, 1, 200, 2047], 8),
    (4, 8, 2, 4, 2048, 16, [0, 1, 200, 2047], 0),
    (4, 8, 2, 4, 2048, 32, [0, 1, 200, 2047], 0),
    (4, 32, 32, 4, 2048, 128, [0, 1, 200, 2047], 0),
    # kv_len on both sides of a split edge (32-key groups: one split or two;
    # 16 splits of 4 groups at S 2048: the second split's first key)
    (1, 32, 4, 22, 2048, 64, [32], 1),
    (1, 32, 4, 22, 2048, 64, [33], 1),
    (2, 32, 4, 22, 2048, 64, [128, 129], 2),
    (2, 32, 4, 22, 2048, 64, [2048, 2016], 3),
    (1, 32, 4, 22, 2048, 64, [5000], 4),         # kv_len past S: all S keys
])
def test_decode_attention(cuda, b, hq, hkv, rows, s, d, kv_len, kv_row):
    """K4: one launch, per-row kv_len on the device; two launches give the
    same bits and a row with kv_len 0 gives 0."""
    q, k, v = _qkv(np.random.default_rng(sum(kv_len) + d), b, hq, hkv, 1, rows, s, d, cuda)
    lens = torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    global_profile.reset()
    got = decode_attention_cuda(q, k, v, lens, kv_row)
    again = decode_attention_cuda(q, k, v, lens, kv_row)
    want = decode_attention_ref(q, k, v, torch.clamp(lens, max=s), kv_row)
    torch.cuda.synchronize()
    assert global_profile.tier_summary() == {"decode_attention": {"cuda": 2}}
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, again)
    for i, n in enumerate(kv_len):
        if n == 0:
            assert not got[i].any()


@pytest.mark.parametrize("b,hq,hkv,rows,s,d,kv_len,kv_row", [
    # Whisper large-v3's decoder (20 heads of 64): the self cache of 448
    # positions, cross-attention over 1500 keys (not a multiple of the 32-key
    # group: no read past S)
    (1, 20, 20, 32, 448, 64, [1], 7),
    (1, 20, 20, 32, 448, 64, [200], 0),
    (1, 20, 20, 32, 448, 64, [448], 31),
    (1, 20, 20, 1, 1500, 64, [1500], 0),
    (2, 20, 20, 2, 1500, 64, [1500, 1500], 0),
    # every head dim, GQA, a row with no key, kv_len past S
    (4, 8, 2, 4, 448, 16, [0, 1, 200, 448], 0),
    (4, 8, 2, 4, 1500, 32, [0, 1, 77, 1500], 0),
    (4, 32, 8, 4, 1500, 128, [0, 1, 777, 1500], 0),
    (1, 32, 32, 1, 2048, 128, [2047], 0),
    (1, 20, 20, 1, 1500, 64, [5000], 0),
])
def test_decode_attention_f32(cuda, b, hq, hkv, rows, s, d, kv_len, kv_row):
    """K4's f32 form over f32 K / V: counted as decode_attention_f32, within
    1e-5 of the plain version, two launches bit-equal, a kv_len 0 row 0."""
    q, k, v = _qkv(np.random.default_rng(sum(kv_len) + d + 1), b, hq, hkv, 1, rows, s, d, cuda)
    k, v = k.float() + 1e-3 * torch.randn_like(k.float()), v.float()
    lens = torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    global_profile.reset()
    got = dispatch.decode_attention(q, k, v, lens, kv_row)
    again = decode_attention_cuda(q, k, v, lens, kv_row)
    want = decode_attention_ref(q, k, v, torch.clamp(lens, max=s), kv_row)
    torch.cuda.synchronize()
    assert global_profile.tier_summary() == {"decode_attention_f32": {"cuda": 2}}
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, again)
    for i, n in enumerate(kv_len):
        if n == 0:
            assert not got[i].any()


def test_decode_attention_f32_refuses_mixed_kv(cuda):
    q = torch.zeros(1, 4, 1, 64, device=cuda)
    kv = torch.zeros(1, 4, 64, 64, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        decode_attention_cuda(q, kv, kv.to(torch.bfloat16), 8)
    with pytest.raises(ValueError, match="bfloat16"):
        decode_attention_cuda(q, kv.to(torch.bfloat16), kv, 8)


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
@pytest.mark.parametrize("m,n,k", [(1, 2560, 2048), (4, 32000, 2048), (8, 2048, 5632),
                                   (32, 2048, 5632), (32, 4096, 11008), (17, 300, 576),
                                   (2, 1000, 512)])
def test_q4_matmul_i8_own_activations_two_launches(cuda, m, n, k, kind):
    """K1's own int8 activations (act_out) are the plain pre-pass's bit for
    bit, and two launches give the same bits, in every form of its plan."""
    rng = np.random.default_rng(m + n + k)
    w = _weight(rng, n, k, cuda, kind)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(cuda)
    act = (torch.empty((m, k), dtype=torch.int8, device=cuda),
           torch.empty((m, k // 32), dtype=torch.float32, device=cuda))
    first = qmatmul_i8_cuda(x, w, act_out=act)
    second = qmatmul_i8_cuda(x, w)
    rq, rs = quantize_act_ref(x)
    torch.cuda.synchronize()
    assert torch.equal(act[0], rq) and torch.equal(act[1].view(torch.int32), rs.view(torch.int32))
    assert torch.equal(first, second)
    _close(first, qmatmul_i8_ref(x, w))


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
    the plain versions under the same names (33 rows: K2's bf16 form at the
    default ZGML_TPU_PREFILL_BF16)."""
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
    assert global_profile.tier_summary() == {"qmatmul_bf16": {"cuda": 1},
                                             "qmatmul_i8": {"cuda": 1, "ref": 1},
                                             "qmatmul_greedy": {"cuda": 1, "ref": 1}}
    # a Q8_0 weight counts under the _q8 names
    w8 = _weight(rng, 64, 64, cuda, "q8_0")
    global_profile.reset()
    dispatch.qmatmul(x, w8)
    dispatch.qmatmul_greedy(x, w8)
    dispatch.qmatmul(torch.ones(33, 64, device=cuda), w8)
    assert global_profile.tier_summary() == {"qmatmul_bf16_q8": {"cuda": 1},
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


@pytest.mark.parametrize("d,f,m", [(4096, 11008, 1), (4096, 11008, 4), (4096, 11008, 7),
                                   (4096, 11008, 32), (2048, 5632, 1), (2048, 5632, 4),
                                   (2048, 5632, 7), (2048, 5632, 8), (2048, 5632, 9),
                                   (2048, 5632, 16), (2048, 5632, 17), (2048, 5632, 32),
                                   (512, 320, 3), (576, 1536, 5), (576, 352, 32), (64, 96, 2)])
def test_fused_ffn(cuda, d, f, m):
    """K6b: every weight block read once for all M rows of a normed h, at
    the n8-tile edges of M, and at D or F whose quant blocks are not a
    multiple of 8 (576, 320, 352: whole scale rows a stage) or of the chunk;
    two launches give the same bits."""
    rng = np.random.default_rng(d + f + m + 2)
    gu, wd = _weight(rng, 2 * f, d, cuda), _weight(rng, d, f, cuda)
    h = torch.from_numpy(rng.standard_normal((1, m, d)).astype(np.float32)).to(cuda)
    global_profile.reset()
    got = fused_ffn_cuda(h, gu, wd)
    again = fused_ffn_cuda(h, gu, wd)
    want = fused_ffn_ref(h, gu, wd)
    torch.cuda.synchronize()
    assert global_profile.tier_summary() == {"fused_ffn": {"cuda": 2}}
    _close(got, want)
    assert torch.equal(got, again)


@pytest.mark.parametrize("m", [4, 7, 32])
def test_fused_ffn_rms_error_against_float64(cuda, m):
    """K6b's split-TF32 products at TinyLlama-1.1B's FFN: its rms error
    against float64 at most 2x the plain version's (f32)."""
    rng = np.random.default_rng(m + 11)
    d, f = 2048, 5632
    gu, wd = _weight(rng, 2 * f, d, cuda), _weight(rng, d, f, cuda)
    h = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32)).to(cuda)
    got, want = fused_ffn_cuda(h, gu, wd), fused_ffn_ref(h, gu, wd)
    g_u = h.double() @ gu.dequant().double().T
    exact = (torch.nn.functional.silu(g_u[:, :f]) * g_u[:, f:]) @ wd.dequant().double().T
    rms, rms_plain = ((y.double() - exact).square().mean().sqrt() for y in (got, want))
    assert rms <= 2 * rms_plain


def _q8_cache(rng, shape, device):
    """An int8 cache (levels, scales) of random values, through the plain
    quantize_columns."""
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return tuple(t.to(device) for t in quantize_columns(x))


@pytest.mark.parametrize("b,hq,hkv,tq,rows,s,d,kv_len,q_off,kv_row", [
    (1, 32, 4, 128, 22, 2048, 64, 128, 0, 5),
    (1, 32, 4, 128, 22, 2048, 64, 1536, 1408, 3),   # TinyLlama chunk 12 of a 1536 prompt
    (1, 32, 32, 128, 4, 2048, 128, 1536, 1408, 1),  # Llama-2-7B, head_dim 128
    (2, 4, 4, 16, 2, 64, 16, 64, 48, 0),
    (1, 8, 2, 8, 1, 64, 32, 0, 0, 0),               # no live key -> 0
    (1, 32, 4, 128, 2, 2048, 64, 1000, 900, 1),     # kv_len ends inside a key tile
    (1, 8, 2, 37, 1, 256, 64, 200, 163, 0),         # Tq not a multiple of 16
    (1, 32, 4, 40, 1, 512, 64, 400, 360, 0),        # n_rep 8 with Tq 40
    (2, 32, 4, 128, 6, 2048, 64, 1536, 1408, 2),    # B 2 through kv_row, split prefix
    (1, 32, 32, 128, 1, 256, 128, 128, 0, 0),       # split 2's keys all masked for early rows
])
def test_flash_attention_q8(cuda, b, hq, hkv, tq, rows, s, d, kv_len, q_off, kv_row):
    """K9 over a stacked int8 cache through kv_row."""
    rng = np.random.default_rng(kv_len + d + 3)
    q = torch.from_numpy(rng.standard_normal((b, hq, tq, d)).astype(np.float32)).to(cuda)
    k, ks = _q8_cache(rng, (rows, hkv, s, d), cuda)
    v, vs = _q8_cache(rng, (rows, hkv, s, d), cuda)
    global_profile.reset()
    got = flash_attention_q8_cuda(q, k, ks, v, vs, kv_len, q_off, kv_row)
    want = flash_attention_q8_ref(q, k, ks, v, vs, kv_len, q_off, kv_row)
    torch.cuda.synchronize()
    assert global_profile.tier_summary() == {"flash_attention_q8": {"cuda": 1}}
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("i8pv", [False, True], ids=["f32p", "i8pv"])
@pytest.mark.parametrize("b,hq,hkv,rows,s,d,kv_len,kv_row", [
    (4, 32, 4, 88, 2048, 64, [1, 200, 2047, 1000], 8),   # TinyLlama batch 4, layer 2
    (4, 32, 4, 88, 2048, 64, [256, 257, 513, 0], 4),     # JAX-block edges, a row of no key
    (1, 32, 32, 4, 2048, 128, [2047], 3),                # Llama-2-7B
    (1, 32, 32, 4, 2048, 128, [200], 0),
    (2, 8, 2, 3, 256, 128, [129, 5], 1),
    (2, 4, 4, 2, 64, 16, [0, 64], 0),
    (2, 8, 2, 2, 200, 64, [200, 77], 0),                 # one JAX block of 200
    (2, 4, 2, 3, 300, 32, [300, 129], 1),                # blocks of 128 over S 300
    (1, 4, 4, 1, 384, 128, [333], 0),                    # blocks of 128 over S 384
])
def test_decode_attention_q8(cuda, b, hq, hkv, rows, s, d, kv_len, kv_row, i8pv):
    """K8 in one launch, q quantized per query head in the kernel, per-row
    kv_len, in both modes: against the plain version of its launch plan
    (the I8PV mode: each split's running max from its first JAX block)
    within 1e-5 * max|o|, or in the I8PV mode 2 x the plain version's own
    move under a 2^-20 / 2^-18 move of its score scale (a p * v_scale /
    psc at a half rounds to the other level), the larger; two launches
    bit-equal; a kv_len 0 row gives 0."""
    rng = np.random.default_rng(sum(kv_len) + d + 4)
    q = torch.from_numpy(rng.standard_normal((b, hq, 1, d)).astype(np.float32)).to(cuda)
    k, ks = _q8_cache(rng, (rows, hkv, s, d), cuda)
    v, vs = _q8_cache(rng, (rows, hkv, s, d), cuda)
    lens = torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    n_split = decode_q8_splits(b, hkv, s, d, torch.cuda.get_device_properties(cuda)
                               .multi_processor_count, i8pv)
    global_profile.reset()
    got = decode_attention_q8_cuda(q, k, ks, v, vs, lens, kv_row, i8pv)
    again = decode_attention_q8_cuda(q, k, ks, v, vs, lens, kv_row, i8pv)

    def plain(scale=None):
        return decode_attention_q8_ref(q, k, ks, v, vs, lens, kv_row, i8pv, split=n_split,
                                       scale=scale)
    want = plain()
    move = max(float((plain((1 + e) / d ** 0.5) - want).abs().max())
               for e in (2.0 ** -20, -2.0 ** -20, 2.0 ** -18, -2.0 ** -18)) if i8pv else 0.0
    torch.cuda.synchronize()
    name = "decode_attention_q8_i8pv" if i8pv else "decode_attention_q8"
    assert global_profile.tier_summary() == {name: {"cuda": 2}}
    err, mx = float((got - want).abs().max()), float(want.abs().max())
    assert bool(torch.isfinite(got).all()) and err <= max(1e-5 * mx, 2 * move), (err, mx, move)
    assert torch.equal(got, again)
    for i, n in enumerate(kv_len):
        if n == 0:
            assert not got[i].any()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("hq,hkv,hd,s,pos,li,a_i8", [
    (32, 4, 64, 2048, 0, 3, False), (32, 4, 64, 2048, 1, 21, False),
    (32, 4, 64, 2048, 200, 5, False), (32, 4, 64, 2048, 2047, 1, False),
    (32, 32, 128, 2048, 200, 0, True), (32, 32, 128, 2048, 2047, 1, True),
    (8, 2, 32, 96, 37, 1, False), (4, 2, 96, 128, 50, 1, True), (8, 2, 256, 256, 130, 1, False)])
def test_attn_block_kv8(cuda, hq, hkv, hd, s, pos, li, a_i8, kind):
    """K7's int8-cache mode, at both A phases: held to the plain version on
    the kernel's own quantized q (and, with a_i8, its own activations)."""
    rng = np.random.default_rng(pos + hd + 5)
    d, n_layers = hq * hd, max(li + 1, 2)
    wqkv = _weight(rng, (hq + 2 * hkv) * hd, d, cuda, kind)
    wo = _weight(rng, d, hq * hd, cuda, kind)
    g = torch.from_numpy((1 + 0.1 * rng.standard_normal(d)).astype(np.float32)).to(cuda)
    x = torch.from_numpy(rng.standard_normal((1, 1, d)).astype(np.float32)).to(cuda)
    ck = _q8_cache(rng, (n_layers, 1, hkv, s, hd), cuda)
    cv = _q8_cache(rng, (n_layers, 1, hkv, s, hd), cuda)
    ck_r, cv_r = tuple(t.clone() for t in ck), tuple(t.clone() for t in cv)
    cos, sin = refs.rope_cos_sin(torch.tensor([pos], device=cuda), hd)
    pos_t = torch.tensor([pos], dtype=torch.int32, device=cuda)
    act = _act_buffers(1, d, cuda) if a_i8 else None
    q8 = (torch.empty((hq, hd), dtype=torch.int8, device=cuda),
          torch.empty(hq, dtype=torch.float32, device=cuda))
    global_profile.reset()
    got = attn_block_cuda(x, g, wqkv, wo, ck, cv, li, pos_t, cos, sin, hq, hkv, 1e-5,
                          a_i8=a_i8, act_out=act, q8_out=q8)
    want = attn_block_ref(x, g, wqkv, wo, ck_r, cv_r, li, pos, cos, sin, hq, hkv, 1e-5,
                          a_i8=a_i8, act=act, q8=q8)
    torch.cuda.synchronize()
    name = "attn_block" + ("_i8" if a_i8 else "") + "_kv8" + ("_q8" if kind == "q8_0" else "")
    assert global_profile.tier_summary() == {name: {"cuda": 1}}
    for a, b in zip(got, want):
        _close(a, b)
    # the kernel's q levels against the plain quantization of the plain q
    q_plain = qkv_ref(x, g, wqkv, cos, sin, hq, hkv, hd, 1e-5, a_i8, act)[0]
    rq, _ = quantize_columns(q_plain.reshape(hq, hd))
    assert int((q8[0].to(torch.int16) - rq.to(torch.int16)).abs().max()) <= 1
    # row pos: the kernel's own k_cur / v_cur quantized; every other row untouched
    rows = torch.arange(s, device=cuda) != pos
    for (lv, sc), (lv_r, sc_r), cur in ((ck, ck_r, got[1]), (cv, cv_r, got[2])):
        wq, ws = quantize_columns(cur[0, :, 0])
        assert torch.equal(lv[li, 0, :, pos], wq)
        assert torch.equal(sc[li, 0, :, pos].view(torch.int32), ws.view(torch.int32))
        assert torch.equal(lv[:, :, :, rows], lv_r[:, :, :, rows])
        assert torch.equal(sc[:, :, :, rows], sc_r[:, :, :, rows])



# -- K6 / K7 on the weight-streaming design: copies that need the 8-row units,
# -- a ragged row group, and the same bits over two launches -------------------

@pytest.mark.parametrize("kind,a_i8", [("q4_0", False), ("q8_0", False), ("q4_0", True)])
@pytest.mark.parametrize("m", [1, 5])
def test_fused_ffn_norm_streamed_rows(cuda, m, kind, a_i8):
    """d 576 (36-byte scale rows: units of 8 rows), F 1536; M 5 is a group of
    4 and a ragged group of 1."""
    d, f = 576, 1536
    rng = np.random.default_rng(m + len(kind) + a_i8)
    gu, wd = _weight(rng, 2 * f, d, cuda, kind), _weight(rng, d, f, cuda, kind)
    g = torch.from_numpy((1 + 0.1 * rng.standard_normal(d)).astype(np.float32)).to(cuda)
    x = torch.from_numpy(rng.standard_normal((m, 1, d)).astype(np.float32)).to(cuda)
    act = _act_buffers(m, d, cuda) if a_i8 else None
    got = fused_ffn_norm_cuda(x, g, gu, wd, 1e-5, a_i8, act)
    want = fused_ffn_norm_ref(x, g, gu, wd, 1e-5, a_i8, act)
    torch.cuda.synchronize()
    _close(got, want)
    if a_i8:
        _check_own_activations(act, x, g)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("a_i8,kv8", [(False, False), (True, False), (False, True),
                                      (True, True)])
def test_attn_block_streamed_rows(cuda, a_i8, kv8, kind):
    """d 576 = 9 heads of 64 over 3 KV heads: 36-byte scale rows (units of
    8 rows), at every A phase and cache."""
    hq, hkv, hd, s, pos, li = 9, 3, 64, 256, 130, 1
    rng = np.random.default_rng(hq + a_i8 + 2 * kv8)
    d = hq * hd
    wqkv = _weight(rng, (hq + 2 * hkv) * hd, d, cuda, kind)
    wo = _weight(rng, d, hq * hd, cuda, kind)
    g = torch.from_numpy((1 + 0.1 * rng.standard_normal(d)).astype(np.float32)).to(cuda)
    x = torch.from_numpy(rng.standard_normal((1, 1, d)).astype(np.float32)).to(cuda)
    if kv8:
        ck, cv = (_q8_cache(rng, (2, 1, hkv, s, hd), cuda) for _ in range(2))
        ck_r, cv_r = tuple(t.clone() for t in ck), tuple(t.clone() for t in cv)
    else:
        ck, cv = (torch.from_numpy(rng.standard_normal((2, 1, hkv, s, hd)).astype(np.float32))
                  .to(cuda, torch.bfloat16) for _ in range(2))
        ck_r, cv_r = ck.clone(), cv.clone()
    cos, sin = refs.rope_cos_sin(torch.tensor([pos], device=cuda), hd)
    pos_t = torch.tensor([pos], dtype=torch.int32, device=cuda)
    act = _act_buffers(1, d, cuda) if a_i8 else None
    q8 = ((torch.empty((hq, hd), dtype=torch.int8, device=cuda),
           torch.empty(hq, dtype=torch.float32, device=cuda)) if kv8 else None)
    got = attn_block_cuda(x, g, wqkv, wo, ck, cv, li, pos_t, cos, sin, hq, hkv, 1e-5,
                          a_i8=a_i8, act_out=act, q8_out=q8)
    want = attn_block_ref(x, g, wqkv, wo, ck_r, cv_r, li, pos, cos, sin, hq, hkv, 1e-5,
                          a_i8=a_i8, act=act, q8=q8)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        _close(a, b)


def _ffn_twice(cuda, kind, a_i8, d, f, m):
    rng = np.random.default_rng(d + f + m)
    gu, wd = _weight(rng, 2 * f, d, cuda, kind), _weight(rng, d, f, cuda, kind)
    g = torch.from_numpy((1 + 0.1 * rng.standard_normal(d)).astype(np.float32)).to(cuda)
    x = torch.from_numpy(rng.standard_normal((1, m, d)).astype(np.float32)).to(cuda)
    return [fused_ffn_norm_cuda(x, g, gu, wd, 1e-5, a_i8) for _ in range(2)]


@pytest.mark.parametrize("kind,a_i8", [("q4_0", False), ("q8_0", False), ("q4_0", True)])
@pytest.mark.parametrize("d,f,m", [(2048, 5632, 1), (2048, 5632, 8), (576, 1536, 5),
                                   (4096, 11008, 1)])
def test_fused_ffn_norm_two_launches_are_bit_equal(cuda, d, f, m, kind, a_i8):
    """K6d / K6a / K6c: fixed rows, warps and sums, no float atomics."""
    first, second = _ffn_twice(cuda, kind, a_i8, d, f, m)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("a_i8,kv8", [(False, False), (True, False), (False, True),
                                      (True, True)])
@pytest.mark.parametrize("hq,hkv,hd,pos", [(32, 4, 64, 0), (32, 4, 64, 2047),
                                           (32, 32, 128, 1), (32, 32, 128, 200)])
def test_attn_block_two_launches_are_bit_equal(cuda, hq, hkv, hd, pos, a_i8, kv8, kind):
    """K7 in every mode: the merge of a KV head's chunks runs in whichever
    block completes its count, always in chunk order; the cache row pos is
    written with the same bits both times."""
    rng = np.random.default_rng(pos + hd + a_i8 + 2 * kv8)
    d, s = hq * hd, 2048
    wqkv = _weight(rng, (hq + 2 * hkv) * hd, d, cuda, kind)
    wo = _weight(rng, d, hq * hd, cuda, kind)
    g = torch.from_numpy((1 + 0.1 * rng.standard_normal(d)).astype(np.float32)).to(cuda)
    x = torch.from_numpy(rng.standard_normal((1, 1, d)).astype(np.float32)).to(cuda)
    if kv8:
        ck, cv = (_q8_cache(rng, (1, 1, hkv, s, hd), cuda) for _ in range(2))
    else:
        ck, cv = (torch.from_numpy(rng.standard_normal((1, 1, hkv, s, hd)).astype(np.float32))
                  .to(cuda, torch.bfloat16) for _ in range(2))
    cos, sin = refs.rope_cos_sin(torch.tensor([pos], device=cuda), hd)
    pos_t = torch.tensor([pos], dtype=torch.int32, device=cuda)
    runs = []
    for _ in range(2):
        out = attn_block_cuda(x, g, wqkv, wo, ck, cv, 0, pos_t, cos, sin, hq, hkv, 1e-5,
                              a_i8=a_i8)
        row = ((ck[0][0, 0, :, pos].clone(), ck[1][0, 0, :, pos].clone()) if kv8
               else (ck[0, 0, :, pos].clone(),))
        runs.append((*out, *row))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))

# -- training: K10 (flash forward with LSE, dQ, dK/dV) and K11 (dx) -------------

def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 numbers at |x| (8 significant bits), in f64,
    exact (frexp / ldexp: no log2 or pow rounding)."""
    ax = x.double().abs()
    _, e = torch.frexp(torch.where(ax > 0, ax, torch.full_like(ax, 2.0 ** -126)))
    return torch.ldexp(torch.ones_like(ax), e - 8)


def assert_bf16_ulp(got: torch.Tensor, want: torch.Tensor):
    """One bf16 ulp per element, or 1e-6 * max|want| where the sum cancels to
    below f32 noise (tests/test_torch_flash_vjp.py)."""
    g, w = got.double(), want.double()
    tol = torch.maximum(torch.maximum(bf16_ulp(w), bf16_ulp(g)),
                        torch.full_like(w, 1e-6 * float(w.abs().max())))
    bad = (g - w).abs() > tol
    assert not bool(bad.any()), (int(bad.sum()), float((g - w).abs().max()))


TRAIN_FLASH_CASES = [
    (4, 32, 4, 512, 512, 64, 512, 0),      # TinyLlama training (B 4, T 512)
    (1, 32, 32, 256, 256, 128, 256, 0),    # Llama-2-7B heads: hd 128, MHA
    (2, 4, 2, 128, 256, 64, 200, 72),      # live prefix < S, offset (tests/test_vjp.py)
    (1, 4, 1, 40, 96, 32, 77, 37),         # ragged tiles
    (2, 8, 4, 33, 33, 16, 33, 0),
    (1, 8, 8, 128, 1024, 128, 1024, 896),  # split prefix: O and LSE through the combine
    (1, 32, 4, 128, 1536, 64, 1536, 1408), # TinyLlama heads at a long prefix
    # the backward's split plans: a grid short of the card (the smoke's
    # kv_len < S case splits dQ's keys; 32 key tiles split dK / dV's
    # queries; at hd 128 both), and a call with no live key
    (1, 32, 4, 128, 512, 64, 300, 172),
    (1, 8, 2, 256, 256, 64, 256, 0),
    (1, 4, 4, 256, 512, 128, 400, 100),
    (1, 8, 2, 16, 64, 32, 0, 0),
]


def _dq64(q, k, v, do, o, lse, kv_len, q_off):
    """dQ in float64 from the same inputs (o and lse the kernel's)."""
    b, hq, tq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    qg = q.double().reshape(b, hkv, hq // hkv, tq, d)
    dog = do.double().reshape(qg.shape)
    kd, vd = k.double(), v.double()
    sc = torch.einsum("bgrqd,bgkd->bgrqk", qg, kd) / d ** 0.5
    ki = torch.arange(s, device=q.device)[None, :]
    qi = torch.arange(tq, device=q.device)[:, None] + q_off
    live = (ki < kv_len) & (ki <= qi)
    p = torch.where(live, torch.exp(sc - lse.double().reshape(*qg.shape[:-1], 1)),
                    torch.zeros_like(sc))
    delta = (dog * o.double().reshape(qg.shape)).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bgrqd,bgkd->bgrqk", dog, vd) - delta) / d ** 0.5
    return torch.einsum("bgrqk,bgkd->bgrqd", ds, kd).reshape(b, hq, tq, d)




# (B, Hq, Hkv, t, d, q_offset) of ring hops: t query rows over one visiting
# block of t keys, the diagonal hop (q_offset 0) and a past block (q_offset t);
# TinyLlama's cp2 hop (t 768), Llama-2-7B heads, ragged tiles, the split prefix
RING_HOP_CASES = [(1, 32, 4, 768, 64, 0), (1, 32, 4, 768, 64, 768), (1, 32, 32, 256, 128, 256),
                  (2, 4, 2, 40, 32, 0), (1, 8, 2, 33, 16, 33), (1, 8, 8, 128, 128, 1024)]


@pytest.mark.parametrize("b,hq,hkv,t,d,q_off", RING_HOP_CASES)
def test_flash_fwd_f32kv(cuda, b, hq, hkv, t, d, q_off):
    """K10f's f32-K/V form (a ring hop under ZGML_TPU_PREFILL_BF16=0): O
    within 1e-5 * max|O| and the LSE within 1e-5 * max|lse| of the plain
    version on the same f32 K/V, two launches bit-equal, counted
    flash_fwd_f32kv; the bf16 form refuses f32 K/V."""
    from zgml_tpu_torch.ops.flash_vjp import flash_fwd_lse_cuda, flash_fwd_lse_ref
    from zgml_tpu_torch.runtime.profile import global_profile
    rng = np.random.default_rng(t + d + q_off)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
               for shape in ((b, hq, t, d), (b, hkv, t, d), (b, hkv, t, d)))
    global_profile.reset()
    o, lse = flash_fwd_lse_cuda(q, k, v, t, q_off)
    o2, lse2 = flash_fwd_lse_cuda(q, k, v, t, q_off)
    assert global_profile.tier_summary() == {"flash_fwd_f32kv": {"cuda": 2}}
    o_ref, lse_ref = flash_fwd_lse_ref(q, k, v, t, q_off)
    torch.cuda.synchronize()
    assert float((o - o_ref).abs().max()) <= 1e-5 * float(o_ref.abs().max())
    assert float((lse - lse_ref).abs().max()) <= 1e-5 * float(lse_ref.abs().max())
    assert torch.equal(o.view(torch.int32), o2.view(torch.int32))
    assert torch.equal(lse.view(torch.int32), lse2.view(torch.int32))
    with pytest.raises(ValueError, match="bf16 form reads bf16 K/V"):
        flash_fwd_lse_cuda(q, k, v, t, q_off, bf16=True)


@pytest.mark.parametrize("b,hq,hkv,tq,s,d,kv_len,q_off", TRAIN_FLASH_CASES)
def test_flash_training_kernels(cuda, b, hq, hkv, tq, s, d, kv_len, q_off):
    """K10f's O equals K3's bit for bit and its LSE the plain one within
    1e-5 * max; K10dq within 1e-5 * max|dQ| and its rms error against
    float64 at most 2x the plain version's (cuBLAS f32); K10dkv's bf16 dK /
    dV within one ulp of the plain versions on the same inputs (o, lse the
    kernel's); K10dq and K10dkv give the same bits over two launches, the
    second from the pre-pass's delta as the backward hands it over."""
    from zgml_tpu_torch.ops.flash_vjp import (flash_delta_cuda, flash_dkv_cuda, flash_dkv_ref,
                                              flash_dq_cuda, flash_dq_ref, flash_fwd_lse_cuda,
                                              flash_fwd_lse_ref)
    rng = np.random.default_rng(tq + d + kv_len)
    q, k, v = _qkv(rng, b, hq, hkv, tq, b, s, d, cuda)
    do = torch.from_numpy(rng.standard_normal((b, hq, tq, d)).astype(np.float32)).to(cuda)
    o, lse = flash_fwd_lse_cuda(q, k, v, kv_len, q_off)
    o_ref, lse_ref = flash_fwd_lse_ref(q, k, v, kv_len, q_off)
    o3 = flash_attention_cuda(q, k, v, kv_len, q_off)
    args = (q, k, v, do, o, lse, kv_len, q_off)
    delta = flash_delta_cuda(do, o)
    dq, dq2 = flash_dq_cuda(*args), flash_dq_cuda(*args, delta=delta)
    (dk, dv), (dk2, dv2) = flash_dkv_cuda(*args), flash_dkv_cuda(*args, delta=delta)
    dq_ref = flash_dq_ref(*args)
    dk_ref, dv_ref = flash_dkv_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(o.view(torch.int32), o3.view(torch.int32))
    torch.testing.assert_close(o, o_ref, rtol=1e-5, atol=1e-5)
    fin = torch.isfinite(lse_ref)
    assert torch.equal(fin, torch.isfinite(lse))
    if bool(fin.any()):
        assert float((lse - lse_ref)[fin].abs().max()) <= 1e-5 * float(lse_ref[fin].abs().max())
    assert bool(torch.isfinite(dq).all())
    assert float((dq - dq_ref).abs().max()) <= 1e-5 * float(dq_ref.abs().max())
    assert dk.dtype == dv.dtype == torch.bfloat16 and dk.shape == (b, hq, s, d)
    assert_bf16_ulp(dk, dk_ref)
    assert_bf16_ulp(dv, dv_ref)
    assert torch.equal(dq.view(torch.int32), dq2.view(torch.int32))
    assert torch.equal(dk.view(torch.int16), dk2.view(torch.int16))
    assert torch.equal(dv.view(torch.int16), dv2.view(torch.int16))
    if kv_len == 0:
        assert not bool(dq.any()) and not bool(dk.float().any()) and not bool(dv.float().any())
        return
    exact = _dq64(*args)

    def rms(x):
        return float((x.double() - exact).square().mean().sqrt())
    assert rms(dq) <= 2 * rms(dq_ref), (rms(dq), rms(dq_ref))


def test_flash_backward_plans_split_the_short_grid(cuda):
    """The smoke's kv_len < S case splits dQ's keys on an H100-sized card;
    the training batch splits neither kernel."""
    from zgml_tpu_torch.ops.flash_vjp import flash_dkv_plan, flash_dq_plan

    def plans(b, hq, hkv, tq, s, d, kv_len, q_off):
        q = torch.empty((b, hq, tq, d), device=cuda)
        k = torch.empty((b, hkv, s, d), device=cuda)
        return flash_dq_plan(q, k, kv_len, q_off).n_split, flash_dkv_plan(q, k, kv_len,
                                                                           q_off).n_split
    if torch.cuda.get_device_properties(0).multi_processor_count >= 100:
        assert plans(1, 32, 4, 128, 512, 64, 300, 172)[0] > 1
        assert plans(1, 8, 2, 256, 256, 64, 256, 0)[1] > 1
    assert plans(4, 32, 4, 512, 512, 64, 512, 0) == (1, 1)


def test_flash_plan_splits_the_long_prefix_on_this_card(cuda):
    """The long-prefix cases above take the split path on the card (the
    plan reads its SM count and the instantiation's blocks per SM), the
    training batch does not."""
    from zgml_tpu_torch.ops.attention import flash_plan

    def plan(b, hq, hkv, tq, s, d, kv_len, q_off, kv8=False):
        q = torch.empty((b, hq, tq, d), device=cuda)
        return flash_plan(q, torch.empty((b, hkv, s, d), device=cuda), kv_len, q_off, kv8)
    for kv8 in (False, True):
        assert plan(1, 32, 4, 128, 2048, 64, 1536, 1408, kv8).n_split > 1
        assert plan(1, 32, 32, 128, 2048, 128, 1536, 1408, kv8).n_split > 1
    assert plan(1, 8, 8, 128, 1024, 128, 1024, 896).n_split > 1
    assert plan(4, 32, 4, 512, 512, 64, 512, 0).n_split == 1


def test_flash_attention_autograd_takes_k10(cuda, monkeypatch):
    """dispatch.flash_attention under autograd (f32 operands,
    ZGML_TPU_PREFILL_BF16=0) launches K10f, K10dq and K10dkv once each, and
    its gradients equal the same Function's plain tier (force_ref) within
    the bounds above."""
    monkeypatch.setenv("ZGML_TPU_PREFILL_BF16", "0")
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 2, 8, 2, 64, 2, 64, 64, cuda)
    grads = []
    for ref in (False, True):
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        global_profile.reset()
        if ref:
            with dispatch.force_ref():
                torch.sum(torch.sin(dispatch.flash_attention(qq, kk, vv, kv_len=64))).backward()
        else:
            torch.sum(torch.sin(dispatch.flash_attention(qq, kk, vv, kv_len=64))).backward()
        tier = "ref" if ref else "cuda"
        assert global_profile.tier_summary() == {n: {tier: 1} for n in
                                                 ("flash_fwd", "flash_dq", "flash_dkv")}
        grads.append((qq.grad, kk.grad, vv.grad))
    (dq, dk, dv), (dq_r, dk_r, dv_r) = grads
    assert float((dq - dq_r).abs().max()) <= 1e-5 * float(dq_r.abs().max())
    for got, want in ((dk, dk_r), (dv, dv_r)):     # group sums of 4 per-head terms
        assert float((got.double() - want.double()).abs().max()) <= \
            4 * float(bf16_ulp(want.abs().max()))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m,n,k", [(512, 2560, 2048), (512, 2048, 5632), (40, 96, 64),
                                   (1, 300, 576), (77, 1000, 512), (512, 11264, 2048),
                                   (512, 32000, 2048)])
def test_qmatmul_bwd(cuda, m, n, k, kind):
    """K11 against g @ dequant(W): K2's bound with N in K's place; two
    launches give the same bits (no atomics, a fixed split); its rms error
    against float64 at most 2x that of the plain version (cuBLAS f32)."""
    from zgml_tpu_torch.ops.qmatmul import qmatmul_bwd_cuda, qmatmul_bwd_ref
    rng = np.random.default_rng(m + n + k)
    w = _weight(rng, n, k, cuda, kind)
    g = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32)).to(cuda)
    got, again, want = qmatmul_bwd_cuda(g, w), qmatmul_bwd_cuda(g, w), qmatmul_bwd_ref(g, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4 * np.sqrt(n))
    assert torch.equal(got, again)
    exact = g.double() @ w.dequant().double()

    def rms(x):
        return float((x.double() - exact).square().mean().sqrt())
    assert rms(got) <= 2 * rms(want), (rms(got), rms(want))


# -- K12 (rmsnorm) and K13 (fused elementwise chain) -------------------------
# K12: f32 rows within 1e-6 * max|out| of refs.rmsnorm (the sum of squares in
# another order; the rest in the plain version's order, rsqrtf as
# torch.rsqrt); bf16 rows within one bf16 ulp of it. K13: the ops that are
# exact in IEEE f32 bit-equal to the plain composition on the card (NaN where
# it is NaN), the others within 1e-6 * max|out|.

@pytest.mark.parametrize("m,d,dtype", [(1, 2048, torch.float32), (128, 2048, torch.float32),
                                       (2048, 2048, torch.float32), (1, 4096, torch.float32),
                                       (7, 100, torch.float32), (3, 64, torch.float32),
                                       (33, 5632, torch.float32), (16, 2048, torch.bfloat16),
                                       (128, 4096, torch.float32), (128, 4096, torch.bfloat16)])
def test_rmsnorm_kernel(cuda, m, d, dtype):
    from zgml_tpu_torch.ops.rmsnorm import rmsnorm_cuda, rmsnorm_ref
    g = torch.Generator(device=cuda).manual_seed(m + d)
    x = torch.randn((m, d), device=cuda, generator=g).to(dtype)
    gamma = 1 + 0.1 * torch.randn(d, device=cuda, generator=g)
    got, want = rmsnorm_cuda(x, gamma), rmsnorm_ref(x, gamma)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_unaligned_x_takes_the_scalar_path(cuda, dtype):
    """x one element past a 16-byte boundary: the plan takes the scalar
    loop, with the same bounds."""
    from zgml_tpu_torch.ops.rmsnorm import launch_plan, rmsnorm_cuda, rmsnorm_ref
    m, d = 64, 2048
    g = torch.Generator(device=cuda).manual_seed(3)
    buf = torch.randn(m * d + 1, device=cuda, generator=g).to(dtype)
    x = buf.view(-1)[1:1 + m * d].view(m, d)
    gamma = 1 + 0.1 * torch.randn(d, device=cuda, generator=g)
    assert not launch_plan(x, gamma).vector
    got, want = rmsnorm_cuda(x, gamma), rmsnorm_ref(x, gamma)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7, atol=0)


@pytest.mark.parametrize("m,d", [(1, 2048), (2048, 2048), (1, 4096), (3, 8192), (300, 512)])
def test_rmsnorm_kernel_two_launches_are_bit_equal(cuda, m, d):
    """A fixed summation order: two launches give the same bits, on every
    plan form (a warp a row, a block a row), each within 1e-6 * max|out| of
    plain."""
    from zgml_tpu_torch.ops.rmsnorm import launch_plan, rmsnorm_cuda, rmsnorm_ref
    g = torch.Generator(device=cuda).manual_seed(m + d)
    x = torch.randn((m, d), device=cuda, generator=g)
    gamma = 1 + 0.1 * torch.randn(d, device=cuda, generator=g)
    assert launch_plan(x, gamma).vector
    a, b = rmsnorm_cuda(x, gamma), rmsnorm_cuda(x, gamma)
    want = rmsnorm_ref(x, gamma)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert float((a - want).abs().max()) <= 1e-6 * float(want.abs().max())


def test_rmsnorm_dispatch_and_autograd_take_k12(cuda, monkeypatch):
    from zgml_tpu_torch.ops.rmsnorm import rmsnorm_ref
    monkeypatch.setenv("ZGML_TPU_KERNELS_FORCE", "rmsnorm")
    monkeypatch.delenv("ZGML_TPU_KERNELS_DISABLE", raising=False)
    x = torch.randn(4, 256, device=cuda, requires_grad=True)
    gamma = torch.ones(256, device=cuda, requires_grad=True)
    global_profile.reset()
    out = dispatch.rmsnorm(x, gamma)
    gx, gg = torch.autograd.grad(out.square().sum(), (x, gamma))
    with torch.no_grad():
        dispatch.rmsnorm(x, gamma)
    with dispatch.force_ref():
        dispatch.rmsnorm(x, gamma)
    xr, gr = x.detach().requires_grad_(), gamma.detach().requires_grad_()
    wx, wg = torch.autograd.grad(rmsnorm_ref(xr, gr).square().sum(), (xr, gr))
    torch.cuda.synchronize()
    assert global_profile.tier_summary()["rmsnorm"] == {"cuda": 2, "ref": 1}
    torch.testing.assert_close(gx, wx, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(gg, wg, rtol=1e-5, atol=1e-6)


_K13_EXACT = {"add", "sub", "mul", "div", "max2", "neg", "recip", "sqr", "sqrt", "abs", "relu",
              "scale", "add_scalar"}


def _chain_check(got, want, exact):
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    g, w = got[~nan], want[~nan]
    if exact:
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    else:
        assert float((g - w).abs().max()) <= 1e-6 * float(w.abs().max())


_K13_BINARY = ("add", "sub", "mul", "div", "max2")
_K13_CASES = [(op, False) for op in ("neg", "recip", "sqr", "sqrt", "exp", "log", "abs", "tanh",
                                     "sigmoid", "relu", "silu", "gelu", "scale", "add_scalar",
                                     *_K13_BINARY)] + [(op, True) for op in _K13_BINARY]


@pytest.mark.parametrize("op,side_left", _K13_CASES)
def test_fused_chain_kernel_per_op(cuda, op, side_left):
    from zgml_tpu_torch.ops.elementwise import BINARY, Step, fused_chain_cuda, fused_chain_ref
    g = torch.Generator(device=cuda).manual_seed(len(op))
    x = torch.randn((300, 517), device=cuda, generator=g)
    x[0, :4] = float("nan")                  # NaN goes through every op
    side = torch.randn(517, device=cuda, generator=g)
    side[5] = float("nan")
    payload = {"scale": 0.37, "add_scalar": -1.25}.get(op, 0.0)
    steps = [Step(op, payload, 0 if op in BINARY else -1, side_left)]
    got, want = fused_chain_cuda(x, steps, [side]), fused_chain_ref(x, steps, [side])
    torch.cuda.synchronize()
    _chain_check(got, want, op in _K13_EXACT)


def test_fused_chain_kernel_chains_and_dispatch(cuda):
    """The graph_ffn chains and a 16-step chain over two broadcast sides;
    dispatch.fused_chain launches K13 and, under autograd, FusedChain."""
    from zgml_tpu_torch.ops.elementwise import Step, fused_chain_cuda, fused_chain_ref
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((64, 333), device=cuda, generator=g)
    sides = [torch.randn((64, 1), device=cuda, generator=g),
             1.5 + torch.rand(333, device=cuda, generator=g)]
    chains = [[Step("silu"), Step("mul", side=0)], [Step("add", side=1), Step("sqr")],
              [Step("neg"), Step("exp"), Step("scale", 0.5), Step("add", side=0),
               Step("div", side=1, side_left=True), Step("tanh"),
               Step("sub", side=0, side_left=True), Step("gelu"), Step("max2", side=1),
               Step("add_scalar", 0.75), Step("sigmoid"), Step("log"), Step("abs"),
               Step("sqrt"), Step("relu"), Step("mul", side=1)]]
    for steps in chains:
        got, want = fused_chain_cuda(x, steps, sides), fused_chain_ref(x, steps, sides)
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    global_profile.reset()
    xg = x.clone().requires_grad_()
    out = dispatch.fused_chain(xg, chains[0], sides[:1])
    (gx,) = torch.autograd.grad(out.sum(), xg)
    with torch.no_grad():
        dispatch.fused_chain(x, chains[0], sides[:1])
    xr = x.clone().requires_grad_()
    (wx,) = torch.autograd.grad(fused_chain_ref(xr, chains[0], sides[:1]).sum(), xr)
    torch.cuda.synchronize()
    assert global_profile.tier_summary()["fused_chain"] == {"cuda": 2}
    torch.testing.assert_close(gx, wx, rtol=0, atol=0)


# K13's side inputs in every form it reads in place (a bias [d] or [1, d],
# rows [B, M, 1], one value) and one it materialises ([B, 1, d]), at a d that
# takes 16-byte vectors and one that does not; a chain of exact ops, so
# bit-equal to plain
_K13_SIDES = [lambda b, m, d: (d,), lambda b, m, d: (1, d), lambda b, m, d: (b, m, 1),
              lambda b, m, d: (), lambda b, m, d: (b, 1, d)]


@pytest.mark.parametrize("shape", [(4, 64, 512), (3, 33, 333)])
@pytest.mark.parametrize("form", range(len(_K13_SIDES)),
                         ids=["bias", "bias_1d", "rows", "scalar", "materialised"])
def test_fused_chain_kernel_side_forms(cuda, shape, form):
    from zgml_tpu_torch.ops.elementwise import Step, fused_chain_cuda, fused_chain_ref
    g = torch.Generator(device=cuda).manual_seed(form + shape[2])
    x = torch.randn(shape, device=cuda, generator=g)
    side = 1.5 + torch.rand(_K13_SIDES[form](*shape), device=cuda, generator=g)
    other = torch.randn(shape, device=cuda, generator=g)
    steps = [Step("add", side=0), Step("div", side=0, side_left=True), Step("mul", side=1),
             Step("sub", side=0, side_left=True), Step("max2", side=0)]
    got, want = fused_chain_cuda(x, steps, [side, other]), fused_chain_ref(x, steps, [side, other])
    torch.cuda.synchronize()
    _chain_check(got, want, True)


@pytest.mark.parametrize("n", [315, 4099, 8 * 1000 + 5])
def test_fused_chain_kernel_ragged_and_misaligned(cuda, n):
    """n not a multiple of a group (the tail runs a lane a thread), and x and
    a side input one element past a 16-byte boundary (all of it a lane a
    thread): bit-equal to plain on exact ops, 1e-6 * max|out| on the rest."""
    from zgml_tpu_torch.ops.elementwise import Step, fused_chain_cuda, fused_chain_ref
    g = torch.Generator(device=cuda).manual_seed(n)
    buf = torch.randn(2 * n + 2, device=cuda, generator=g)
    for x, side in ((buf[:n], buf[n + 1:2 * n + 1]), (buf[1:n + 1], buf[n + 2:])):
        for steps, exact in (([Step("mul", side=0), Step("add_scalar", 0.5), Step("relu")], True),
                             ([Step("silu"), Step("sub", side=0, side_left=True),
                               Step("tanh")], False)):
            got, want = fused_chain_cuda(x, steps, [side]), fused_chain_ref(x, steps, [side])
            torch.cuda.synchronize()
            _chain_check(got, want, exact)


def test_fused_chain_kernel_reads_a_bias_in_place(cuda):
    """A bias [d] added to [M, d] is one kernel a call: the side is not
    materialised at x's shape first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from zgml_tpu_torch.ops.elementwise import Step, fused_chain_cuda, fused_chain_ref
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn((256, 2048), device=cuda, generator=g)
    bias = torch.randn(2048, device=cuda, generator=g)
    steps = [Step("add", side=0)]
    _chain_check(fused_chain_cuda(x, steps, [bias]), fused_chain_ref(x, steps, [bias]), True)
    torch.cuda.synchronize()
    for _ in range(3):             # a profiler window now and then comes back empty
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fused_chain_cuda(x, steps, [bias])
            torch.cuda.synchronize()
        kernels = {ev.key: ev.count for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA and ev.count}
        if kernels:
            break
    assert len(kernels) == 1 and "chain_kernel" in next(iter(kernels)), kernels
    assert next(iter(kernels.values())) <= 5


# -- the whole-stack decode megacalls: K14 (f32 operands) and K15 (bf16 ones) --

# K14 / K15 against their plain versions: with f32 operands K7's and K6d's
# bound once per layer (each layer hands its f32 summation-order difference on
# to the next); with bf16 ones both round each operand row to bf16, and a value
# the two sum in another order can round to either neighbour, so the bound is
# that of tests/test_torch_tapekernel.py
MEGA_REL_PER_LAYER = 1e-5
TAPE_BF16_RTOL = 1e-2


def _stack(rng, n_layers, hq, hkv, hd, f, device):
    from zgml_tpu_torch.ops.stackkernel import StackedLayers
    d = hq * hd

    def norm():
        return torch.from_numpy((1 + 0.1 * rng.standard_normal(d)).astype(np.float32)).to(device)
    layers = [{"attn_norm": norm(), "ffn_norm": norm(),
               "wqkv": _weight(rng, (hq + 2 * hkv) * hd, d, device),
               "wo": _weight(rng, d, hq * hd, device),
               "w_gate_up": _weight(rng, 2 * f, d, device), "w_down": _weight(rng, d, f, device)}
              for _ in range(n_layers)]
    return StackedLayers(layers, hq, hkv, 1e-5)


STACK_CASES = [
    (4, 32, 4, 64, 5632, 2048, 2047),     # TinyLlama-1.1B widths
    (3, 32, 4, 64, 5632, 2048, 0),        # pos 0: phase B empty
    (2, 32, 32, 128, 11008, 256, 200),    # Llama-2-7B widths: hd 128, MHA
    (2, 8, 2, 128, 768, 300, 257),        # S not a multiple of the chunk
    (2, 16, 4, 32, 1024, 130, 129),       # K14's smallest head dim
    (2, 4, 4, 256, 512, 64, 33)]          # the largest


@pytest.mark.parametrize("mode,n_layers,hq,hkv,hd,f,s,pos", [
    (mode, *case) for mode in ("stack", "tape", "tape_f32") for case in STACK_CASES
    if mode != "tape" or case[3] in (64, 128, 256)])    # K15: the JAX tape's head dims
def test_stack_decode(cuda, mode, n_layers, hq, hkv, hd, f, s, pos):
    """K14 and K15 (both modes) against their plain versions: x_out, k_cur and
    v_cur within MEGA_REL_PER_LAYER * L * max|out| with f32 operands,
    TAPE_BF16_RTOL * max|out| with bf16 ones; every layer's cache row pos is
    the kernel's own k_cur / v_cur in bf16 (with f32 operands within one bf16
    ulp of the plain version's row, or the bound near 0), and no other row
    changes."""
    from zgml_tpu_torch.ops.stackkernel import stacked_decode_cuda, stacked_decode_ref
    from zgml_tpu_torch.ops.tapekernel import Tape, tape_decode_cuda, tape_decode_ref
    rng = np.random.default_rng(pos + hd + n_layers)
    stack = _stack(rng, n_layers, hq, hkv, hd, f, cuda)
    d = hq * hd
    x = torch.from_numpy(rng.standard_normal((1, 1, d)).astype(np.float32)).to(cuda)
    ck = torch.from_numpy(rng.standard_normal((n_layers, 1, hkv, s, hd)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    cv = torch.from_numpy(rng.standard_normal((n_layers, 1, hkv, s, hd)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    cos, sin = refs.rope_cos_sin(torch.tensor([pos], device=cuda), hd)
    pos_t = torch.tensor([pos], dtype=torch.int32, device=cuda)
    ck_r, cv_r = ck.clone(), cv.clone()
    if mode == "stack":
        got = stacked_decode_cuda(x, stack, ck, cv, pos_t, cos, sin)
        want = stacked_decode_ref(x, stack, ck_r, cv_r, pos, cos, sin)
    else:
        tape = Tape(stack, ())
        got = tape_decode_cuda(x, tape, ck, cv, pos_t, cos, sin, bf16=mode == "tape")
        want = tape_decode_ref(x, tape, ck_r, cv_r, pos, cos, sin, bf16=mode == "tape")
    torch.cuda.synchronize()
    assert got[1].shape == want[1].shape == (n_layers, hkv, hd)
    rtol = TAPE_BF16_RTOL if mode == "tape" else MEGA_REL_PER_LAYER * n_layers
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=0, atol=rtol * float(b.abs().max()))
    assert torch.equal(ck[:, 0, :, pos], got[1].to(torch.bfloat16))
    assert torch.equal(cv[:, 0, :, pos], got[2].to(torch.bfloat16))
    if mode != "tape":
        for c, c_r in ((ck, ck_r), (cv, cv_r)):
            row, row_r = c[:, 0, :, pos].double(), c_r[:, 0, :, pos].double()
            tol = torch.clamp(bf16_ulp(row_r), min=rtol * float(row_r.abs().max()))
            assert bool(((row - row_r).abs() <= tol).all())
    rows = torch.arange(s, device=cuda) != pos
    assert torch.equal(ck[:, :, :, rows], ck_r[:, :, :, rows])
    assert torch.equal(cv[:, :, :, rows], cv_r[:, :, :, rows])


def test_stack_decode_dispatch_and_head_dims(cuda, monkeypatch):
    """dispatch.stacked_decode / tape_decode launch K14 / K15 (tape_decode_f32
    under ZGML_TPU_TAPE_BF16=0), force_ref() their plain versions; a head dim
    without an instantiation raises NotImplementedError, never falls back."""
    from zgml_tpu_torch.ops.tapekernel import Tape
    rng = np.random.default_rng(3)
    stack = _stack(rng, 2, 8, 2, 64, 256, cuda)
    tape = Tape(stack, ())
    ck = torch.zeros((2, 1, 2, 64, 64), dtype=torch.bfloat16, device=cuda)
    cv = torch.zeros_like(ck)
    x = torch.ones((1, 1, 512), device=cuda)
    cos, sin = refs.rope_cos_sin(torch.tensor([5], device=cuda), 64)
    pos = torch.tensor([5], dtype=torch.int32, device=cuda)
    global_profile.reset()
    dispatch.stacked_decode(x, stack, ck, cv, pos, cos, sin)
    dispatch.tape_decode(x, tape, ck, cv, pos, cos, sin)
    monkeypatch.setenv("ZGML_TPU_TAPE_BF16", "0")
    dispatch.tape_decode(x, tape, ck, cv, pos, cos, sin)
    with dispatch.force_ref():
        dispatch.stacked_decode(x, stack, ck, cv, pos, cos, sin)
    torch.cuda.synchronize()
    assert global_profile.tier_summary() == {"stack_decode": {"cuda": 1, "ref": 1},
                                             "tape_decode": {"cuda": 1},
                                             "tape_decode_f32": {"cuda": 1}}
    wide = _stack(rng, 1, 2, 1, 288, 64, cuda)
    ck2 = torch.zeros((1, 1, 1, 8, 288), dtype=torch.bfloat16, device=cuda)
    cos2, sin2 = refs.rope_cos_sin(torch.tensor([1], device=cuda), 288)
    with pytest.raises(NotImplementedError, match="head_dim 288"):
        dispatch.stacked_decode(torch.ones((1, 1, 576), device=cuda), wide, ck2, ck2.clone(),
                                pos.clone().fill_(1), cos2, sin2)


STACK_CHAIN_CASES = [
    (3, 32, 4, 64, 5632, 2048, 300),      # TinyLlama-1.1B widths, 3 chunks live
    (2, 32, 32, 128, 11008, 512, 257),    # Llama-2-7B widths, S not a chunk multiple
    (2, 8, 2, 64, 768, 64, 0)]            # pos 0: phase B empty


@pytest.mark.parametrize("mode", ("stack", "tape_f32"))
@pytest.mark.parametrize("n_layers,hq,hkv,hd,f,s,pos", STACK_CHAIN_CASES)
def test_stack_decode_is_the_layer_chain_bit_for_bit(cuda, mode, n_layers, hq, hkv, hd, f, s,
                                                     pos):
    """K14 and tape_decode_f32 run K7's and K6d's arithmetic in their order:
    every layer's k_cur / v_cur, the final x and the cache equal the
    per-layer chain's bit for bit, and a second launch gives the same bits
    (the KV heads' arrival counts are back at zero for every layer)."""
    from zgml_tpu_torch.ops.stackkernel import layer_chain, stacked_decode_cuda
    from zgml_tpu_torch.ops.tapekernel import Tape, tape_decode_cuda
    rng = np.random.default_rng(pos + n_layers)
    stack = _stack(rng, n_layers, hq, hkv, hd, f, cuda)
    d = hq * hd
    x = torch.from_numpy(rng.standard_normal((1, 1, d)).astype(np.float32)).to(cuda)
    ck = torch.from_numpy(rng.standard_normal((n_layers, 1, hkv, s, hd)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    cv = torch.from_numpy(rng.standard_normal((n_layers, 1, hkv, s, hd)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    cos, sin = refs.rope_cos_sin(torch.tensor([pos], device=cuda), hd)
    pos_t = torch.tensor([pos], dtype=torch.int32, device=cuda)

    def run(kc, vc):
        if mode == "stack":
            return stacked_decode_cuda(x, stack, kc, vc, pos_t, cos, sin)
        return tape_decode_cuda(x, Tape(stack, ()), kc, vc, pos_t, cos, sin, bf16=False)
    ck1, cv1, ck2, cv2 = ck.clone(), cv.clone(), ck.clone(), cv.clone()
    got, again = run(ck1, cv1), run(ck.clone(), cv.clone())
    want = layer_chain(x, stack, ck2, cv2, pos_t, cos, sin)
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, again):
        assert torch.equal(a.reshape(b.shape), b) and torch.equal(a, c)
    assert torch.equal(ck1, ck2) and torch.equal(cv1, cv2)


@pytest.mark.parametrize("n_layers,hq,hkv,hd,f,s,pos", STACK_CHAIN_CASES)
def test_tape_decode_rms_error_and_two_launches(cuda, n_layers, hq, hkv, hd, f, s, pos):
    """K15 (bf16 operands): two launches give the same bits, its rms error
    against float64 is at most 2x the plain version's, and it is nearer its
    plain version than the f32 function (the per-layer chain) is: at most
    half the chain's rms distance, so a K15 without its bf16 roundings of
    the weights and operand rows fails."""
    from zgml_tpu_torch.ops.stackkernel import layer_chain, stacked_decode_f64
    from zgml_tpu_torch.ops.tapekernel import Tape, bf16_weight, tape_decode_cuda, tape_decode_ref
    rng = np.random.default_rng(pos + 7 * n_layers)
    tape = Tape(_stack(rng, n_layers, hq, hkv, hd, f, cuda), ())
    d = hq * hd
    x = torch.from_numpy(rng.standard_normal((1, 1, d)).astype(np.float32)).to(cuda)
    ck = torch.from_numpy(rng.standard_normal((n_layers, 1, hkv, s, hd)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    cv = torch.from_numpy(rng.standard_normal((n_layers, 1, hkv, s, hd)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    cos, sin = refs.rope_cos_sin(torch.tensor([pos], device=cuda), hd)
    pos_t = torch.tensor([pos], dtype=torch.int32, device=cuda)
    got = tape_decode_cuda(x, tape, ck.clone(), cv.clone(), pos_t, cos, sin)
    again = tape_decode_cuda(x, tape, ck.clone(), cv.clone(), pos_t, cos, sin)
    want = tape_decode_ref(x, tape, ck.clone(), cv.clone(), pos, cos, sin)
    chain = layer_chain(x, tape.stack, ck.clone(), cv.clone(), pos_t, cos, sin)
    exact = stacked_decode_f64(x, tape.stack, ck, cv, pos, cos, sin, bf16_weight)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    flat = [torch.cat([t.reshape(-1) for t in out]).double() for out in (got, want, chain)]

    def rms(a, b):
        return float(torch.sqrt(torch.mean((a - b) ** 2)))
    assert rms(flat[0], exact) <= 2.0 * rms(flat[1], exact)
    assert rms(flat[0], flat[1]) <= 0.5 * rms(flat[2], flat[1])


# -- the bf16 forms (ZGML_TPU_PREFILL_BF16) -----------------------------------------
#
# K2's bf16 form within 1e-5 * max|y| of qmatmul_ref(bf16=True) (exact products
# of the same bf16 operands, f32 sums in another order), its pre-pass's bf16(x)
# bit-equal to torch's rounding; the flash family's against the plain version
# of the same launch plan within max(1e-4 * max|o|, 2 x the plain version's own
# move when its score scale moves by FLIP_EPS: a score an ulp off rounds its p
# to the other bf16 neighbour), K10dq within 1e-5, dK one bf16 ulp, dV one ulp
# or 2 x its own flips' move; each bit-equal over two launches and its rms
# error against float64 of the same roundings at most 2x the plain version's
# (the flash forward: or 2x the flips' rms move).

FLIP_EPS = (2.0 ** -20, -2.0 ** -20, 2.0 ** -18, -2.0 ** -18)


def _flip_moves(plain, d):
    base = plain(1.0 / d ** 0.5)
    moves = [plain((1 + e) / d ** 0.5) - base for e in FLIP_EPS]
    return (max(float(m.abs().max()) for m in moves),
            max(float(m.double().square().mean().sqrt()) for m in moves))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m,n,k", [(1, 2560, 2048), (1, 32000, 2048), (4, 64, 5632),
                                   (5, 96, 64), (40, 1000, 576), (128, 2048, 2048),
                                   (130, 77, 96), (512, 333, 5632), (512, 11264, 2048),
                                   (128, 12288, 4096)])
def test_qmatmul_bf16(cuda, m, n, k, kind):
    from zgml_tpu_torch.ops.qmatmul import GEMV_MAX_M
    rng = np.random.default_rng(m * 5 + n)
    w = _weight(rng, n, k, cuda, kind)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(cuda)
    xb = torch.empty((m, k), dtype=torch.bfloat16, device=cuda)
    tiled = m > GEMV_MAX_M
    got = qmatmul_cuda(x, w, True, xb_out=xb if tiled else None)
    again, want = qmatmul_cuda(x, w, True), qmatmul_ref(x, w, True)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert torch.equal(got, again)
    if tiled:
        assert torch.equal(xb.view(torch.int16), x.to(torch.bfloat16).view(torch.int16))
        exact = refs.bf16_round(x).double() @ refs.bf16_round(w.dequant()).double().T

        def rms(y):
            return float((y.double() - exact).square().mean().sqrt())
        assert rms(got) <= 2 * rms(want), (rms(got), rms(want))


def test_dispatch_takes_the_bf16_form_by_tier(cuda, monkeypatch):
    """The default flags: K2's bf16 form where JAX's row tile holds 32 rows
    (33 rows, and one row at tier_rows 128), the f32 one below (9 rows with
    I8DOT=0) and everywhere under ZGML_TPU_PREFILL_BF16=0."""
    monkeypatch.delenv("ZGML_TPU_PREFILL_BF16", raising=False)
    rng = np.random.default_rng(2)
    w = _weight(rng, 64, 64, cuda)
    global_profile.reset()
    dispatch.qmatmul(torch.ones(33, 64, device=cuda), w)
    dispatch.qmatmul(torch.ones(1, 64, device=cuda), w, tier_rows=128)
    monkeypatch.setenv("ZGML_TPU_I8DOT", "0")
    dispatch.qmatmul(torch.ones(9, 64, device=cuda), w)
    monkeypatch.setenv("ZGML_TPU_PREFILL_BF16", "0")
    dispatch.qmatmul(torch.ones(33, 64, device=cuda), w)
    assert global_profile.tier_summary() == {"qmatmul_bf16": {"cuda": 2}, "qmatmul": {"cuda": 2}}


@pytest.mark.parametrize("kv8", [False, True])
@pytest.mark.parametrize("b,hq,hkv,tq,rows,s,d,kv_len,q_off,kv_row", [
    (1, 32, 4, 128, 22, 2048, 64, 128, 0, 5),
    (1, 32, 4, 128, 22, 2048, 64, 1536, 1408, 3),  # the prefix split across blocks
    (1, 32, 32, 128, 4, 2048, 128, 1536, 1408, 1), # head_dim 128, split
    (1, 32, 32, 128, 4, 2048, 128, 256, 128, 1),
    (2, 4, 4, 16, 2, 64, 16, 64, 48, 0),           # a group of 64 keys (S 64)
    (1, 8, 2, 37, 1, 200, 64, 200, 163, 0),        # groups of 8 keys (S 200), Tq 37
    (1, 8, 2, 8, 1, 64, 32, 0, 0, 0),              # no live key -> 0
])
def test_flash_attention_bf16(cuda, b, hq, hkv, tq, rows, s, d, kv_len, q_off, kv_row, kv8):
    from zgml_tpu_torch.ops.attention import (combine_partials_ref, flash_group, flash_partials_ref,
                                              flash_plan)
    rng = np.random.default_rng(kv_len + d + kv8)
    q, k, v = _qkv(rng, b, hq, hkv, tq, rows, s, d, cuda)
    scales = {}
    if kv8:
        k, ks = quantize_columns(k.float())
        v, vs = quantize_columns(v.float())
        scales = dict(ks=ks, vs=vs)

        def launch():
            return flash_attention_q8_cuda(q, k, ks, v, vs, kv_len, q_off, kv_row, True)
    else:
        def launch():
            return flash_attention_cuda(q, k, v, kv_len, q_off, kv_row, True)
    got, again = launch(), launch()
    plan = flash_plan(q, k, kv_len, q_off, kv8, flash_group(s, kv8))

    def plain(scale=None, exact=False):
        return combine_partials_ref(*flash_partials_ref(q, k, v, kv_len, q_off, kv_row, plan=plan,
                                                        bf16=True, exact=exact, scale=scale,
                                                        **scales))[0]
    want, exact = plain(), plain(exact=True)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    if kv_len == 0:
        assert not bool(got.any())
        return
    move, move_rms = _flip_moves(plain, d)
    err = float((got - want).abs().max())
    assert err <= max(1e-4 * float(want.abs().max()), 2 * move), (err, move)

    def rms(y):
        return float((y.double() - exact).square().mean().sqrt())
    assert rms(got) <= 2 * max(rms(want), move_rms), (rms(got), rms(want), move_rms)


@pytest.mark.parametrize("b,hq,hkv,tq,s,d,kv_len,q_off", TRAIN_FLASH_CASES)
def test_flash_training_kernels_bf16(cuda, b, hq, hkv, tq, s, d, kv_len, q_off):
    from zgml_tpu_torch.ops.attention import (combine_partials_ref, flash_group, flash_partials_ref,
                                              flash_plan)
    from zgml_tpu_torch.ops.flash_vjp import (flash_delta_cuda, flash_dkv_cuda, flash_dkv_ref,
                                              flash_dq_cuda, flash_dq_ref, flash_fwd_lse_cuda)
    rng = np.random.default_rng(tq + d + kv_len + 1)
    q, k, v = _qkv(rng, b, hq, hkv, tq, b, s, d, cuda)
    do = torch.from_numpy(rng.standard_normal((b, hq, tq, d)).astype(np.float32)).to(cuda)
    o, lse = flash_fwd_lse_cuda(q, k, v, kv_len, q_off, bf16=True)
    o3 = flash_attention_cuda(q, k, v, kv_len, q_off, 0, True)
    plan = flash_plan(q, k, kv_len, q_off, False, flash_group(s, False))

    def plain(scale=None):
        return combine_partials_ref(*flash_partials_ref(q, k, v, kv_len, q_off, plan=plan,
                                                        bf16=True, scale=scale))
    o_ref, lse_ref = plain()
    args = (q, k, v, do, o, lse, kv_len, q_off)
    delta = flash_delta_cuda(do, o)
    dq, dq2 = flash_dq_cuda(*args, bf16=True), flash_dq_cuda(*args, delta=delta, bf16=True)
    (dk, dv), (dk2, dv2) = (flash_dkv_cuda(*args, bf16=True),
                            flash_dkv_cuda(*args, delta=delta, bf16=True))
    dq_ref = flash_dq_ref(*args, bf16=True)
    dk_ref, dv_ref = flash_dkv_ref(*args, bf16=True)
    torch.cuda.synchronize()
    assert torch.equal(o.view(torch.int32), o3.view(torch.int32))
    assert torch.equal(dq.view(torch.int32), dq2.view(torch.int32))
    assert torch.equal(dk.view(torch.int16), dk2.view(torch.int16))
    assert torch.equal(dv.view(torch.int16), dv2.view(torch.int16))
    if kv_len == 0:
        assert not bool(o.any()) and not bool(dq.any()) and not bool(dv.float().any())
        return
    move, _ = _flip_moves(lambda sc: plain(sc)[0], d)
    assert float((o - o_ref).abs().max()) <= max(1e-4 * float(o_ref.abs().max()), 2 * move)
    fin = torch.isfinite(lse_ref)
    assert torch.equal(fin, torch.isfinite(lse))
    assert float((lse - lse_ref)[fin].abs().max()) <= 1e-5 * float(lse_ref[fin].abs().max())
    assert float((dq - dq_ref).abs().max()) <= 1e-5 * float(dq_ref.abs().max())
    assert_bf16_ulp(dk, dk_ref)
    # dV takes bf16(p), whose flips may land on any element: each may also
    # move by twice the largest move of the plain dV under the scale moves
    dv_move = max(float((flash_dkv_ref(*args, bf16=True, scale=(1 + e) / d ** 0.5)[1].double()
                         - dv_ref.double()).abs().max()) for e in FLIP_EPS)
    g_, w_ = dv.double(), dv_ref.double()
    tol = torch.maximum(torch.maximum(bf16_ulp(w_), bf16_ulp(g_)),
                        torch.full_like(w_, max(1e-6 * float(w_.abs().max()), 2 * dv_move)))
    assert not bool(((g_ - w_).abs() > tol).any())
    qb, dob = refs.bf16_round(q), refs.bf16_round(do)
    exact = _dq64_bf16(qb, k, v, do, dob, o, lse, kv_len, q_off)

    def rms(x):
        return float((x.double() - exact).square().mean().sqrt())
    assert rms(dq) <= 2 * rms(dq_ref), (rms(dq), rms(dq_ref))


def _dq64_bf16(qb, k, v, do, dob, o, lse, kv_len, q_off):
    """dQ's bf16 form in float64: s from bf16(q), dP from bf16(dO)."""
    b, hq, tq, d = qb.shape
    hkv, s = k.shape[1], k.shape[2]
    qg = qb.double().reshape(b, hkv, hq // hkv, tq, d)
    kd, vd = k.double(), v.double()
    sc = torch.einsum("bgrqd,bgkd->bgrqk", qg, kd) / d ** 0.5
    ki = torch.arange(s, device=qb.device)[None, :]
    qi = torch.arange(tq, device=qb.device)[:, None] + q_off
    p = torch.where((ki < kv_len) & (ki <= qi),
                    torch.exp(sc - lse.double().reshape(*qg.shape[:-1], 1)), torch.zeros_like(sc))
    delta = (do.double().reshape(qg.shape) * o.double().reshape(qg.shape)).sum(-1, keepdim=True)
    dp = torch.einsum("bgrqd,bgkd->bgrqk", dob.double().reshape(qg.shape), vd)
    return torch.einsum("bgrqk,bgkd->bgrqd", p * (dp - delta) / d ** 0.5, kd).reshape(b, hq, tq, d)


def test_flash_attention_autograd_takes_k10_bf16(cuda, monkeypatch):
    """At the default flags dispatch.flash_attention under autograd launches
    K10's bf16 forms once each (counted flash_fwd_bf16, ...), and dQ equals
    the same Function's plain tier within 1e-5 * max."""
    monkeypatch.delenv("ZGML_TPU_PREFILL_BF16", raising=False)
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, 2, 8, 2, 64, 2, 64, 64, cuda)
    grads = []
    for ref in (False, True):
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        global_profile.reset()
        with dispatch.force_ref() if ref else torch.enable_grad():
            torch.sum(torch.sin(dispatch.flash_attention(qq, kk, vv, kv_len=64))).backward()
        tier = "ref" if ref else "cuda"
        assert global_profile.tier_summary() == {n: {tier: 1} for n in
                                                 ("flash_fwd_bf16", "flash_dq_bf16",
                                                  "flash_dkv_bf16")}
        grads.append(qq.grad)
    assert float((grads[0] - grads[1]).abs().max()) <= 1e-5 * float(grads[1].abs().max())
