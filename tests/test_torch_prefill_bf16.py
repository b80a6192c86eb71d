"""ZGML_TPU_PREFILL_BF16 at the JAX package's default (unset: on): the port's
prefill against the JAX package's, on the CPU.

Both packages run with ZGML_TPU_PREFILL_BF16 unset, ZGML_TPU_SCALES=f16 and
the I8A flags set explicitly (ZGML_TPU_ATTN_I8A / ZGML_TPU_FFN_I8A = 1), set
around both sides; the JAX side runs its Pallas kernels in interpret mode,
the port its plain versions (CPU tensors). What is held:

  - which K2 calls take the bf16 form: ops/qmatmul.bf16_tier against the
    decision JAX's `_qmm_diff` takes (its int8 tier, or dot_bf16) for every
    M in 1..2100, I8DOT on and off;
  - K2's plain bf16 form against `_q4_matmul` / `_q8_matmul` with
    dot_bf16=True at M 40 and 128, and the f32 form at M 536 (m_pad 8 * 67:
    JAX's row tile is 8 rows, below the bf16 tier), and the prefill head's
    one row at tier_rows 128; within 1e-5 * max|y| (exact products of the
    same bf16 operands, f32 sums in another order);
  - K3, K9 and K10f against `_flash` / `_flash_q8` / `_flash_fwd` at
    bf16=True, and K10dq / K10dkv against `_flash_dq` / `_flash_dkv`:
    lse and dQ within 1e-5 * max|.|, dK / dV within one bf16 ulp (or 1e-6 *
    max) per element; o within FLIP bounds: the same bf16 operands and the
    same running-max steps, but the scores' f32 sums run in another order,
    and a score one ulp off rounds its p to the other bf16 neighbour (a
    flip) about once in 4e4 pairs, moving o by up to ~2e-3 of max|o| where
    the key carries much of its row's weight (measured 4.5e-5 and 1.7e-4 of
    max|o| in two of these cases). So o is held within max(1e-5 * max|o|,
    2 x the largest move of the port's own bf16 form when its score scale
    moves by 2^-20 or 2^-18, which flips p's the same way), and the f32 form
    must leave JAX's by more than that;
  - a 2-layer d 256 model's prefill logits and first greedy token against
    the JAX engine, and a training step's gradients against jax.grad;
  - ROADMAP C.4 itself: the port at ZGML_TPU_PREFILL_BF16=0 (the function
    it computed while it ignored the flag) leaves the JAX default by more
    than the bounds the bf16 form meets.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zgml_tpu.io.llama_loader import load_llama as jax_load_llama
from zgml_tpu.models import llama as jllama
from zgml_tpu.nn import losses as jlosses
import importlib

from zgml_tpu.ops import attention as jattn
from zgml_tpu.ops import flash_vjp as jfv
from zgml_tpu.quant import kv_cache as jkv
from zgml_tpu.quant.repack import quantize_weight
from zgml_tpu.runtime.engine import LlamaEngine as JaxEngine

from zgml_tpu_torch.io.gguf import GGMLType
from zgml_tpu_torch.io.llama_loader import load_llama, params_from_jax
from zgml_tpu_torch.models.llama import LlamaConfig, LlamaModel
from zgml_tpu_torch.nn import losses
from zgml_tpu_torch.nn.train import value_and_grad
from zgml_tpu_torch.ops import attention, dispatch, flash_vjp, qmatmul
from zgml_tpu_torch.quant import packed
from zgml_tpu_torch.runtime.engine import LlamaEngine
from zgml_tpu_torch.runtime.profile import global_profile
from zgml_tpu_torch.utils.synthetic import write_synthetic_llama_gguf
from zgml_tpu_torch.utils.tree import flatten

torch.set_num_threads(1)
jqmm = importlib.import_module("zgml_tpu.ops.qmatmul")   # the package re-exports a function

FLAGS = {"ZGML_TPU_SCALES": "f16", "ZGML_TPU_ATTN_I8A": "1", "ZGML_TPU_FFN_I8A": "1"}
RTOL = 1e-5                 # a kernel's function on shared inputs
MODEL_CFG = LlamaConfig(vocab_size=96, d_model=256, n_heads=8, n_kv_heads=2, d_ff=192,
                        n_layers=2, max_seq_len=96)   # tests/test_torch_llama.py PREFILL_CFG
# tests/test_torch_training.py's dense and quantized training configs
DENSE_CFG = LlamaConfig(vocab_size=96, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
                        n_layers=2, max_seq_len=64)
QUANT_CFG = LlamaConfig(vocab_size=96, d_model=512, n_heads=8, n_kv_heads=2, d_ff=1024,
                        n_layers=2, max_seq_len=96)
PROMPT_LEN, CHUNK = 20, 64
N, K = 384, 512
_FROM_PLANAR = {"q4_0": packed.from_planar_q4_0, "q8_0": packed.from_planar_q8_0}


@pytest.fixture(autouse=True)
def _flags(monkeypatch):
    for k in ("ZGML_TPU_PREFILL_BF16", "ZGML_TPU_I8DOT", "ZGML_TPU_KERNELS",
              "ZGML_TPU_KERNELS_DISABLE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in FLAGS.items():
        monkeypatch.setenv(k, v)


FLIP_EPS = (2.0 ** -20, -2.0 ** -20, 2.0 ** -18, -2.0 ** -18)


def _flip_bound(f, d, want):
    """max(RTOL * max|want|, 2 x the largest move of f(scale), the port's
    bf16 form at score scale `scale`, when 1/sqrt(d) moves by FLIP_EPS)."""
    base = f(1.0 / d ** 0.5)
    move = max(float((f((1 + e) / d ** 0.5) - base).abs().max()) for e in FLIP_EPS)
    return max(RTOL * float(np.max(np.abs(want))), 2 * move)


def _rms(got, want):
    return float(np.sqrt(np.mean((np.asarray(got, np.float64) - want) ** 2)))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _weight(rng, kind, n=N, k=K):
    jpw = quantize_weight(rng.standard_normal((n, k)).astype(np.float32) * 0.1, kind)
    jpw = dataclasses.replace(jpw, qvals=jnp.asarray(jpw.qvals), scales=jnp.asarray(jpw.scales))
    pw = _FROM_PLANAR[kind](np.asarray(jpw.qvals), np.asarray(jpw.scales), n, k, device="cpu")
    return jpw, pw


# -- K2: which calls, and the function -------------------------------------------

def _jax_tiers(monkeypatch, ms):
    """The tier JAX's `_qmm_diff` picks for an m-row call, for each m: "i8",
    "bf16" or "f32", read from the kernel it calls and its dot_bf16."""
    seen = []

    def spy(tier):
        def f(x, qvals, scales, **kw):
            seen.append("bf16" if kw.get("dot_bf16") else tier)
            return jnp.zeros((x.shape[0], qvals.shape[1]), jnp.float32)
        return f
    monkeypatch.setattr(jqmm, "_q8_matmul", spy("f32"))
    monkeypatch.setattr(jqmm, "_q8_matmul_i8", spy("i8"))
    jpw = quantize_weight(np.ones((128, 128), np.float32), "q8_0")
    out = []
    for m in ms:         # traced, not run: the tier is picked while tracing
        jax.eval_shape(lambda x: jqmm.qmatmul_pallas(x, jpw),
                       jax.ShapeDtypeStruct((m, 128), jnp.float32))
        out.append(seen.pop())
    return out


@pytest.mark.parametrize("i8dot", ["1", "0"])
def test_bf16_tier_matches_jax_for_every_m(monkeypatch, i8dot):
    """qmatmul.bf16_tier and the int8 rule of dispatch.qmatmul against the
    tier JAX's qmatmul_pallas calls, for M = 1 .. 2100."""
    monkeypatch.setenv("ZGML_TPU_I8DOT", i8dot)
    ms = list(range(1, 2101))
    want = _jax_tiers(monkeypatch, ms)
    got = []
    for m in ms:
        i8 = i8dot == "1" and m <= qmatmul.I8_MAX_ROWS
        got.append("i8" if i8 else "bf16" if qmatmul.bf16_tier(m, i8) else "f32")
    bad = [(m, g, w) for m, g, w in zip(ms, got, want) if g != w]
    assert not bad, bad[:10]
    assert "f32" in want and "bf16" in want      # 536 = 8 * 67: JAX's row tile is 8
    assert want[535] == "f32"


@pytest.mark.parametrize("kind", ["q4_0", "q8_0"])
@pytest.mark.parametrize("m,tier", [(40, "bf16"), (128, "bf16"), (536, "f32")])
def test_k2_default_tier_matches_jax(kind, m, tier):
    """dispatch.qmatmul (the plain bf16 form, or the f32 one at M 536)
    against qmatmul_pallas at the default flags, within 1e-5 * max|y|."""
    rng = np.random.default_rng(m + len(kind))
    jpw, pw = _weight(rng, kind)
    x = rng.standard_normal((m, K)).astype(np.float32)
    want = np.asarray(jqmm.qmatmul_pallas(jnp.asarray(x), jpw))
    global_profile.reset()
    got = dispatch.qmatmul(torch.from_numpy(x), pw).numpy()
    name = qmatmul.counter("qmatmul", kind, tier == "bf16")
    assert global_profile.tier_summary() == {name: {"ref": 1}}
    assert _rel(got, want) <= RTOL


@pytest.mark.parametrize("kind", ["q4_0", "q8_0"])
def test_k2_bf16_form_is_jax_dot_bf16(kind):
    """The plain bf16 form against `_q4_matmul` / `_q8_matmul` called with
    dot_bf16=True directly (one 128-row tile), and not the f32 function:
    the f32 form leaves it by far more than RTOL."""
    rng = np.random.default_rng(3)
    jpw, pw = _weight(rng, kind)
    x = rng.standard_normal((128, K)).astype(np.float32)
    f = jqmm._q8_matmul if kind == "q8_0" else jqmm._q4_matmul
    bk = 512 if kind == "q8_0" else 256
    want = np.asarray(f(jnp.asarray(x), jpw.qvals, jpw.scales, bm=128, bn=128, bk=bk,
                        out_dtype=np.dtype(np.float32), dot_bf16=True))[:, :N]
    xt = torch.from_numpy(x)
    assert _rel(qmatmul.qmatmul_ref(xt, pw, bf16=True).numpy(), want) <= RTOL
    assert _rel(qmatmul.qmatmul_ref(xt, pw).numpy(), want) > 100 * RTOL


def test_prefill_head_row_takes_the_chunks_bf16_tier():
    """The prefill head's last row of a 128-row chunk (tier_rows 128): JAX
    computes the whole chunk in bf16, so the port's one-row call computes
    the bf16 function too (its row within 1e-5 of JAX's row)."""
    rng = np.random.default_rng(4)
    jpw, pw = _weight(rng, "q4_0")
    x = rng.standard_normal((128, K)).astype(np.float32)
    want = np.asarray(jqmm.qmatmul_pallas(jnp.asarray(x), jpw))[-1:]
    global_profile.reset()
    got = dispatch.qmatmul(torch.from_numpy(x[-1:]), pw, tier_rows=128).numpy()
    assert global_profile.tier_summary() == {"qmatmul_bf16": {"ref": 1}}
    assert _rel(got, want) <= RTOL


# -- K3, K9, K10 -----------------------------------------------------------------

FLASH_CASES = [
    # b, hq, hkv, tq, rows, s, d, kv_len, q_offset, kv_row
    (1, 8, 2, 16, 1, 64, 64, 16, 0, None),          # one key tile
    (2, 4, 4, 16, 2, 64, 16, 64, 48, None),         # batch 2, last chunk
    (1, 8, 2, 16, 3, 384, 32, 300, 284, 2),         # 3 key tiles of 128, kv_row 2
    (1, 4, 4, 32, 1, 512, 128, 416, 384, None),     # head_dim 128, 4 key tiles
]


def _kv(rng, rows, hkv, s, d):
    k = torch.from_numpy(rng.standard_normal((rows, hkv, s, d)).astype(np.float32)).bfloat16()
    v = torch.from_numpy(rng.standard_normal((rows, hkv, s, d)).astype(np.float32)).bfloat16()
    return k, v, jnp.asarray(k.float().numpy(), jnp.bfloat16), jnp.asarray(v.float().numpy(),
                                                                          jnp.bfloat16)


@pytest.mark.parametrize("b,hq,hkv,tq,rows,s,d,kv_len,q_off,kv_row", FLASH_CASES)
def test_k3_bf16_matches_jax(b, hq, hkv, tq, rows, s, d, kv_len, q_off, kv_row):
    """dispatch.flash_attention (K3's plain bf16 form, counted attention_bf16)
    against flash_attention_pallas at the default flags, within the FLIP
    bound; the f32 form (ZGML_TPU_PREFILL_BF16=0 on the port alone) leaves
    it everywhere, not in a few flipped p's: its rms distance is more than
    10x the bf16 form's."""
    rng = np.random.default_rng(s + kv_len)
    q = rng.standard_normal((b, hq, tq, d)).astype(np.float32)
    k, v, jk, jv = _kv(rng, rows, hkv, s, d)
    want = np.asarray(jattn.flash_attention_pallas(jnp.asarray(q), jk, jv, kv_len=kv_len,
                                                   q_offset=q_off, kv_row=kv_row))
    global_profile.reset()
    got = dispatch.flash_attention(torch.from_numpy(q), k, v, kv_len, q_off, kv_row or 0)
    assert global_profile.tier_summary() == {"attention_bf16": {"ref": 1}}
    tq_ = torch.from_numpy(q)
    bound = _flip_bound(lambda sc: attention.flash_attention_ref(
        tq_, k, v, kv_len, q_off, kv_row or 0, bf16=True, scale=sc), d, want)
    err = float(np.max(np.abs(got.numpy() - want)))
    assert err <= bound, (err, bound)
    f32 = attention.flash_attention_ref(tq_, k, v, kv_len, q_off, kv_row or 0)
    assert _rms(f32.numpy(), want) > 10 * _rms(got.numpy(), want)


Q8_CASES = [
    # b, hq, hkv, tq, rows, s, d, kv_len, q_offset, kv_row
    (1, 8, 2, 16, 1, 128, 64, 16, 0, None),         # one key tile (s < 256)
    (1, 8, 2, 16, 3, 768, 64, 600, 584, 2),         # 3 key tiles of 256, kv_row 2
    (1, 4, 4, 16, 1, 384, 128, 300, 284, None),     # 384: tiles of 128, head_dim 128
]


@pytest.mark.parametrize("b,hq,hkv,tq,rows,s,d,kv_len,q_off,kv_row", Q8_CASES)
def test_k9_bf16_matches_jax(b, hq, hkv, tq, rows, s, d, kv_len, q_off, kv_row):
    """dispatch.flash_attention_q8 (K9's plain bf16 form) against
    flash_attention_q8_pallas at the default flags over the same int8
    cache, within the FLIP bound."""
    rng = np.random.default_rng(s + tq)
    q = rng.standard_normal((b, hq, tq, d)).astype(np.float32)

    def cols(x):
        lv, sc = jkv.quantize_columns(jnp.asarray(x))
        return (lv, sc), (torch.from_numpy(np.array(np.asarray(lv).swapaxes(-1, -2), order="C")),
                          torch.from_numpy(np.array(sc)))
    (jkq, jks), pk = cols(rng.standard_normal((rows, hkv, s, d)).astype(np.float32))
    (jvq, jvs), pv = cols(rng.standard_normal((rows, hkv, s, d)).astype(np.float32))
    want = np.asarray(jattn.flash_attention_q8_pallas(jnp.asarray(q), jkq, jks, jvq, jvs,
                                                      kv_len=kv_len, q_offset=q_off,
                                                      kv_row=kv_row))
    global_profile.reset()
    got = dispatch.flash_attention_q8(torch.from_numpy(q), *pk, *pv, kv_len, q_off, kv_row or 0)
    assert global_profile.tier_summary() == {"flash_attention_q8_bf16": {"ref": 1}}
    tq_ = torch.from_numpy(q)
    bound = _flip_bound(lambda sc: attention.flash_attention_q8_ref(
        tq_, *pk, *pv, kv_len, q_off, kv_row or 0, bf16=True, scale=sc), d, want)
    err = float(np.max(np.abs(got.numpy() - want)))
    assert err <= bound, (err, bound)


def _ulp_bf16(x):
    ax = np.abs(np.asarray(x, np.float64))
    _, e = np.frexp(np.where(ax > 0, ax, 2.0 ** -126))
    return np.ldexp(1.0, e - 8)


def _assert_ulps(got, want, what, floor_rel=1e-6, moved=0.0):
    """got within one bf16 ulp of want per element, or floor_rel * max|want|,
    or 2 x `moved` (the largest move of the port's own value when its p's
    flip)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    floor = max(floor_rel * np.max(np.abs(want)), 2 * moved)
    over = np.abs(got - want) > np.maximum(np.maximum(_ulp_bf16(want), _ulp_bf16(got)), floor)
    assert not over.any(), (what, int(over.sum()), float(np.max(np.abs(got - want))))


K10_GEOMETRIES = [
    # b, hq, hkv, tq, s, kv_len, q_off, d
    (1, 2, 2, 128, 128, 128, 0, 64),       # MHA, one key tile
    (2, 4, 2, 128, 256, 200, 72, 64),      # GQA, two key tiles, live prefix < S
    (1, 4, 1, 64, 256, 96, 32, 32),        # n_rep 4, Tq below the row block
]


@pytest.mark.parametrize("geom", K10_GEOMETRIES)
def test_k10_bf16_matches_jax_kernels(geom):
    """K10f's o (the FLIP bound) and lse, K10dq's dQ and K10dkv's
    per-query-head dK / dV at bf16=True, each from the same inputs (the
    backward from JAX's o and lse)."""
    b, hq, hkv, tq, s, kv_len, q_off, d = geom
    rng = np.random.default_rng(sum(geom))
    q = rng.standard_normal((b, hq, tq, d)).astype(np.float32)
    k, v, jk, jv = _kv(rng, b, hkv, s, d)
    do = rng.standard_normal((b, hq, tq, d)).astype(np.float32)
    bk = min(128, s)
    kw = dict(hq=hq, n_rep=hq // hkv, bq=min(128, tq), bk=bk, scale=1.0 / d ** 0.5, bf16=True)
    lens = jnp.asarray([kv_len, q_off, 0], jnp.int32)
    jq, jdo = jnp.asarray(q.reshape(b * hq, tq, d)), jnp.asarray(do.reshape(b * hq, tq, d))
    jk, jv = jk.reshape(b * hkv, s, d), jv.reshape(b * hkv, s, d)
    jo, jlse = jfv._flash_fwd(jq, jk, jv, lens, **kw)
    jdq = jfv._flash_dq(jq, jk, jv, jdo, jo, jlse, lens, **kw)
    jdk, jdv = jfv._flash_dkv(jq, jk, jv, jdo, jo, jlse, lens, **kw)
    jo, jlse = np.asarray(jo).reshape(b, hq, tq, d), np.asarray(jlse)[..., 0].reshape(b, hq, tq)
    tq_, tdo = torch.from_numpy(q), torch.from_numpy(do)
    o, lse = flash_vjp.flash_fwd_lse_ref(tq_, k, v, kv_len, q_off, bf16=True, group=bk)
    bound = _flip_bound(lambda sc: flash_vjp.flash_fwd_lse_ref(
        tq_, k, v, kv_len, q_off, bf16=True, group=bk, scale=sc)[0], d, jo)
    assert float(np.max(np.abs(o.numpy() - jo))) <= bound
    assert _rel(lse.numpy(), jlse) <= RTOL
    to, tlse = torch.from_numpy(jo.copy()), torch.from_numpy(jlse.copy())
    dq = flash_vjp.flash_dq_ref(tq_, k, v, tdo, to, tlse, kv_len, q_off, bf16=True)
    assert _rel(dq.numpy(), np.asarray(jdq).reshape(b, hq, tq, d)) <= RTOL
    dk, dv = flash_vjp.flash_dkv_ref(tq_, k, v, tdo, to, tlse, kv_len, q_off, bf16=True)
    # dV takes bf16(p), which flips as o's p do, on any element: each may
    # also move by twice the largest move of the port's own dV when the
    # score scale moves
    base = dv.double()
    moved = max(float((flash_vjp.flash_dkv_ref(tq_, k, v, tdo, to, tlse, kv_len, q_off,
                                               bf16=True, scale=(1 + e) / d ** 0.5)[1]
                       .double() - base).abs().max()) for e in FLIP_EPS)

    def f32(a):
        return np.asarray(jnp.asarray(a).astype(jnp.float32)).reshape(b, hq, s, d)
    _assert_ulps(dk.float().numpy(), f32(jdk), "dk")
    _assert_ulps(dv.float().numpy(), f32(jdv), "dv", moved=moved)


# -- the whole prefill and a training step -------------------------------------

@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("prefill_bf16") / "d256_q4.gguf")
    write_synthetic_llama_gguf(path, MODEL_CFG, seed=12)
    return path


def _prefills(path, port_flag=None):
    """(JAX logits at the default flags, the port's logits with
    ZGML_TPU_PREFILL_BF16 = port_flag (None: unset, as JAX's), the port's
    placement counts) of one 64-row chunk of a 20-token prompt."""
    prompt = np.random.default_rng(7).integers(0, MODEL_CFG.vocab_size, PROMPT_LEN)
    jmodel, jgf = jax_load_llama(path)
    jgf.close()
    jlogits = np.asarray(JaxEngine(jmodel, prefill_chunk=CHUNK).prefill(prompt))[0]
    pmodel, pgf = load_llama(path, device="cpu")
    pgf.close()
    with pytest.MonkeyPatch.context() as mp:
        if port_flag is not None:
            mp.setenv("ZGML_TPU_PREFILL_BF16", port_flag)
        global_profile.reset()
        plogits = LlamaEngine(pmodel, prefill_chunk=CHUNK).prefill(prompt)[0].numpy()
        tiers = global_profile.tier_summary()
    return jlogits, plogits, tiers


# the whole model: one bf16 rounding of an activation that the two packages'
# f32 sums put on either side of a tie moves the logits by up to ~1e-3 of
# max|logit| at this config, as bf16 cache rounding does at f32
# (tests/test_torch_llama.py); measured 1.0e-7 here (no flip), and C.4's
# difference 9.0e-3
MODEL_RTOL = 2e-3


def test_prefill_logits_and_first_token_match_jax_default(model_path):
    """The 2-layer d 256 model's prefill (64-row chunk: K2 and K3 in their
    bf16 forms on both sides) at the default flags: logits within
    MODEL_RTOL * max|logit| of the JAX engine's, the same first greedy
    token."""
    jlogits, plogits, tiers = _prefills(model_path)
    assert tiers["qmatmul_bf16"] == {"ref": 4 * MODEL_CFG.n_layers + 1}, tiers
    assert tiers["attention_bf16"] == {"ref": MODEL_CFG.n_layers}, tiers
    assert "qmatmul" not in tiers and "attention" not in tiers
    assert _rel(plogits, jlogits) <= MODEL_RTOL
    top2 = np.sort(jlogits)[-2:]
    assert top2[1] - top2[0] > MODEL_RTOL * np.max(np.abs(jlogits))
    assert int(np.argmax(plogits)) == int(np.argmax(jlogits))


def test_c4_port_f32_prefill_is_another_function(model_path):
    """ROADMAP C.4: the port's prefill with f32 operands (the function it
    computed while it ignored the flag; ZGML_TPU_PREFILL_BF16=0 on the port
    alone) against JAX at the default leaves MODEL_RTOL by far."""
    jlogits, plogits, tiers = _prefills(model_path, port_flag="0")
    assert "qmatmul_bf16" not in tiers and "attention" in tiers
    assert _rel(plogits, jlogits) > 3 * MODEL_RTOL


def _jax_loss(model, layout=None):
    def loss(params, x, y):
        logits, _ = model.forward(params, x, model.init_cache(x.shape[0], layout=layout), 0)
        return jlosses.cross_entropy_idx(logits[:, :-1], y[:, 1:])
    return loss


def _port_loss(cfg):
    def loss(params, x, y):
        return losses.cross_entropy_idx(LlamaModel(cfg, params)(x)[:, :-1], y[:, 1:])
    return loss


def _moves(loss_fn, params, tokens, draws=3):
    """How far the port's own gradients move (max|dg| / max|g| per tensor),
    and its loss (|dl| / |l|), when tok_embd is scaled by (1 + 1e-7 N(0,
    1)): the bf16 roundings of K, V, q, p and the projections' operands
    flip under f32 noise of that size (tests/test_torch_training.py)."""
    l0, g0 = value_and_grad(loss_fn, params, tokens, tokens)
    gen = torch.Generator().manual_seed(0)
    leaves0, _ = flatten(g0)
    moved, lmove = [0.0] * len(leaves0), 0.0
    for _ in range(draws):
        emb = params["tok_embd"]
        p2 = {**params, "tok_embd": emb * (1 + 1e-7 * torch.randn(emb.shape, generator=gen))}
        l1, g1 = value_and_grad(loss_fn, p2, tokens, tokens)
        moved = [max(m, _rel(a, b)) for m, a, b in zip(moved, flatten(g1)[0], leaves0)]
        lmove = max(lmove, abs(float(l1) - float(l0)) / abs(float(l0)))
    return moved, lmove


def _check_grads(got, want_leaves, moves):
    """Each tensor within max(1e-4, 2 x the port's own move) of JAX's,
    relative to its max|grad| (tests/test_torch_training.py's rule)."""
    errs = [_rel(g, w) for g, w in zip(flatten(got)[0], want_leaves)]
    bounds = [max(1e-4, 2 * m) for m in moves]
    assert all(e <= b for e, b in zip(errs, bounds)), list(zip(errs, bounds))


def test_dense_training_step_grads_match_jax_default():
    """One step's gradients of every leaf of a dense 2-layer GQA llama (d
    128, B 2 x T 32) at the default flags: the flash VJP's bf16 forms on
    both sides (counted flash_*_bf16), the loss within max(1e-6, 2 x the
    port's own move), every gradient within max(1e-4, 2 x its own move) of
    jax.grad's."""
    jp = jllama.init_params(DENSE_CFG, seed=6, scale=0.1)
    tokens = np.random.default_rng(7).integers(0, DENSE_CFG.vocab_size, (2, 32)).astype(np.int32)
    jmodel = jllama.LlamaModel(DENSE_CFG, jp)
    jl, jg = jax.value_and_grad(_jax_loss(jmodel))(jp, jnp.asarray(tokens), jnp.asarray(tokens))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), DENSE_CFG, device="cpu")
    tt = torch.from_numpy(tokens)
    global_profile.reset()
    tl, tg = value_and_grad(_port_loss(DENSE_CFG), tp, tt, tt)
    tiers = global_profile.tier_summary()
    assert tiers["flash_fwd_bf16"] == tiers["flash_dq_bf16"] == tiers["flash_dkv_bf16"] == \
        {"ref": DENSE_CFG.n_layers}, tiers
    moves, lmove = _moves(_port_loss(DENSE_CFG), tp, tt)
    assert abs(float(tl) - float(jl)) <= max(1e-6, 2 * lmove) * abs(float(jl))
    want = params_from_jax(jax.tree.map(np.asarray, jg), DENSE_CFG, device="cpu")
    _check_grads(tg, flatten(want)[0], moves)


def _trainable(params):
    return {"tok_embd": params["tok_embd"], "out_norm": params["out_norm"],
            "layers": [{"attn_norm": ly["attn_norm"], "ffn_norm": ly["ffn_norm"]}
                       for ly in params["layers"]]}


def _merge(full, tr):
    return {**full, "tok_embd": tr["tok_embd"], "out_norm": tr["out_norm"],
            "layers": [{**ly, **t} for ly, t in zip(full["layers"], tr["layers"])]}


def test_frozen_q4_training_step_grads_match_jax_default(tmp_path):
    """The quantized d 512 model of tests/test_torch_training.py, Q4_0
    projections frozen, B 2 x T 24 (48 rows: K2's bf16 form forward, K11
    backward, on both sides) at the default flags: the gradients of tok_embd
    and the norms against jax.grad (_check_grads), the loss within max(1e-5,
    2 x the port's own move): every projection rounds its x to bf16 here,
    and a 1e-7 perturbation of the embedding moves the port's logits by
    3.7e-3 of max|logit|, as far as they lie from JAX's (measured); the
    losses were 5.9e-5 apart."""
    path = str(tmp_path / "q4.gguf")
    write_synthetic_llama_gguf(path, QUANT_CFG, quant=GGMLType.Q4_0, seed=21)
    jmodel, jgf = jax_load_llama(path)
    jgf.close()
    tmodel, tgf = load_llama(path, device="cpu")
    tgf.close()
    tokens = np.random.default_rng(8).integers(0, QUANT_CFG.vocab_size, (2, 24)).astype(np.int32)
    jfull = jmodel.params
    jloss = _jax_loss(jmodel, layout="unrolled")
    jl, jg = jax.value_and_grad(lambda tr: jloss(_merge(jfull, tr), jnp.asarray(tokens),
                                                 jnp.asarray(tokens)))(_trainable(jfull))
    tt, full = torch.from_numpy(tokens), tmodel.params

    def loss(tr, x, y):
        return _port_loss(QUANT_CFG)(_merge(full, tr), x, y)
    global_profile.reset()
    tl, tg = value_and_grad(loss, _trainable(full), tt, tt)
    tiers = global_profile.tier_summary()
    n_proj = QUANT_CFG.n_layers * 4 + 1
    assert tiers["qmatmul_bf16"] == tiers["qmatmul_bwd"] == {"ref": n_proj}, tiers
    assert tiers["flash_dkv_bf16"] == {"ref": QUANT_CFG.n_layers}
    moves, lmove = _moves(loss, _trainable(full), tt)
    assert abs(float(tl) - float(jl)) <= max(1e-5, 2 * lmove) * abs(float(jl))
    _check_grads(tg, flatten(jax.tree.map(np.asarray, jg))[0], moves)
