"""K10 (training's flash attention: forward with LSE, dQ, dK/dV) and its
autograd Function against the JAX package, on the CPU.

The JAX side runs its Pallas kernels `_flash_fwd`, `_flash_dq` and
`_flash_dkv` in interpret mode at ZGML_TPU_PREFILL_BF16=0 (f32 operands, the
port's prefill function; ZGML_TPU_SCALES=f16 as elsewhere, set around both
packages), on the three geometries of tests/test_vjp.py with bf16 K/V, as
training's cache holds them. The port runs its plain versions
(ops/flash_vjp.py), which the kernels are held to on the card
(tests/test_torch_kernels.py). Bounds: o, lse and dQ within 1e-5 * max|.|
(f32 sums in another order); dK and dV, which both packages write in bf16,
within one bf16 ulp per element (a sum that rounds the other way), or
1e-6 * max|.| for an element whose sum cancels to where f32 rounding noise
is more than its ulp (measured: a dK element of 1.9e-7 beside a max of
1.23, 4 of its ulps apart).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zgml_tpu.ops import flash_vjp as jfv
from zgml_tpu.ops.attention import flash_attention_pallas

from zgml_tpu_torch.ops import dispatch
from zgml_tpu_torch.ops.flash_vjp import (flash_dkv_ref, flash_dq_ref, flash_fwd_lse_ref,
                                          group_sum)
from zgml_tpu_torch.runtime.profile import global_profile

torch.set_num_threads(1)

GEOMETRIES = [
    (1, 2, 2, 128, 128, 128, 0),      # MHA, full causal square
    (2, 4, 2, 128, 256, 200, 72),     # GQA n_rep=2, live prefix < S, offset
    (1, 4, 1, 64, 256, 96, 32),       # GQA n_rep=4, Tq below the 128-row block
]
D = 64
FLAGS = {"ZGML_TPU_PREFILL_BF16": "0", "ZGML_TPU_SCALES": "f16"}


@pytest.fixture(autouse=True)
def _flags(monkeypatch):
    for k, v in FLAGS.items():
        monkeypatch.setenv(k, v)


def _inputs(b, hq, hkv, tq, s, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, tq, D)).astype(np.float32)
    # bf16 K/V as the cache holds them: round once, hand both packages the values
    k = torch.from_numpy(rng.standard_normal((b, hkv, s, D)).astype(np.float32)).to(torch.bfloat16)
    v = torch.from_numpy(rng.standard_normal((b, hkv, s, D)).astype(np.float32)).to(torch.bfloat16)
    do = rng.standard_normal((b, hq, tq, D)).astype(np.float32)
    return q, k, v, do


def _jnp_bf16(t):
    return jnp.asarray(t.to(torch.float32).numpy()).astype(jnp.bfloat16)


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if hasattr(a, "dtype") else a


def ulp_bf16(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 numbers at |x| (8 significant bits), exact."""
    ax = np.abs(np.asarray(x, np.float64))
    _, e = np.frexp(np.where(ax > 0, ax, 2.0 ** -126))
    return np.ldexp(1.0, e - 8)


def _assert_rel(got, want, rtol, what):
    err = np.max(np.abs(got - want))
    assert err <= rtol * np.max(np.abs(want)), (what, err, np.max(np.abs(want)))


def _assert_ulps(got, want, what, floor_rel=1e-6):
    got, want = got.astype(np.float64), want.astype(np.float64)
    floor = floor_rel * np.max(np.abs(want))
    over = np.abs(got - want) > np.maximum(np.maximum(ulp_bf16(want), ulp_bf16(got)), floor)
    assert not over.any(), (what, int(over.sum()), float(np.max(np.abs(got - want))))


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_plain_k10_matches_jax_kernels(geom):
    """K10f's o and lse, K10dq's dQ and K10dkv's per-query-head dK / dV, each
    from the same inputs (o and lse from the JAX forward) on both sides."""
    b, hq, hkv, tq, s, kv_len, q_off = geom
    q, k, v, do = _inputs(b, hq, hkv, tq, s, seed=sum(geom))
    kw = dict(hq=hq, n_rep=hq // hkv, bq=min(128, tq), bk=min(128, s), scale=1.0 / D ** 0.5,
              bf16=False)
    lens = jnp.asarray([kv_len, q_off, 0], jnp.int32)
    jq, jk, jv = jnp.asarray(q.reshape(b * hq, tq, D)), _jnp_bf16(k), _jnp_bf16(v)
    jk, jv = jk.reshape(b * hkv, s, D), jv.reshape(b * hkv, s, D)
    jo, jlse = jfv._flash_fwd(jq, jk, jv, lens, **kw)
    jdo = jnp.asarray(do.reshape(b * hq, tq, D))
    jdq = jfv._flash_dq(jq, jk, jv, jdo, jo, jlse, lens, **kw)
    jdk, jdv = jfv._flash_dkv(jq, jk, jv, jdo, jo, jlse, lens, **kw)
    jo, jlse = np.asarray(jo).reshape(b, hq, tq, D), np.asarray(jlse)[..., 0].reshape(b, hq, tq)

    tq_, tdo = torch.from_numpy(q), torch.from_numpy(do)
    o, lse = flash_fwd_lse_ref(tq_, k, v, kv_len, q_off)
    _assert_rel(o.numpy(), jo, 1e-5, "o")
    _assert_rel(lse.numpy(), jlse, 1e-5, "lse")
    # the backward from JAX's own o and lse, so each kernel is held alone
    to, tlse = torch.from_numpy(jo.copy()), torch.from_numpy(jlse.copy())
    dq = flash_dq_ref(tq_, k, v, tdo, to, tlse, kv_len, q_off)
    _assert_rel(dq.numpy(), np.asarray(jdq).reshape(b, hq, tq, D), 1e-5, "dq")
    dk, dv = flash_dkv_ref(tq_, k, v, tdo, to, tlse, kv_len, q_off)
    assert dk.dtype == dv.dtype == torch.bfloat16
    _assert_ulps(dk.float().numpy(), _np(jdk).reshape(b, hq, s, D), "dk")
    _assert_ulps(dv.float().numpy(), _np(jdv).reshape(b, hq, s, D), "dv")


def test_dkv_rounds_do_to_bf16_as_jax_does():
    """dK's dP takes dO rounded to bf16 (flash_vjp.py:275) even at
    PREFILL_BF16=0: with f32 dO the plain dK leaves JAX's by more than an
    ulp, with the rounding it does not."""
    b, hq, hkv, tq, s, kv_len, q_off = GEOMETRIES[1]
    q, k, v, do = _inputs(b, hq, hkv, tq, s, seed=5)
    kw = dict(hq=hq, n_rep=hq // hkv, bq=tq, bk=128, scale=1.0 / D ** 0.5, bf16=False)
    lens = jnp.asarray([kv_len, q_off, 0], jnp.int32)
    jq, jk, jv = (jnp.asarray(q.reshape(b * hq, tq, D)), _jnp_bf16(k).reshape(b * hkv, s, D),
                  _jnp_bf16(v).reshape(b * hkv, s, D))
    jo, jlse = jfv._flash_fwd(jq, jk, jv, lens, **kw)
    jdk, _ = jfv._flash_dkv(jq, jk, jv, jnp.asarray(do.reshape(b * hq, tq, D)), jo, jlse, lens,
                            **kw)
    jdk = _np(jdk).reshape(b, hq, s, D)
    args = (torch.from_numpy(q), k, v)
    o = torch.from_numpy(np.array(jo).reshape(b, hq, tq, D))
    lse = torch.from_numpy(np.array(jlse)[..., 0].reshape(b, hq, tq))
    dk, _ = flash_dkv_ref(*args, torch.from_numpy(do), o, lse, kv_len, q_off)
    _assert_ulps(dk.float().numpy(), jdk, "dk")
    # dO already on the bf16 grid: the plain dK's rounding of dO is then a no-op
    do_b = torch.from_numpy(do).to(torch.bfloat16).to(torch.float32)
    dk_f32, _ = flash_dkv_ref(*args, do_b + 1e-3 * torch.from_numpy(do), o, lse, kv_len, q_off)
    assert not torch.equal(dk_f32, dk)


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_flash_attention_grads_match_jax_grad(geom):
    """dispatch.flash_attention under autograd (FlashAttention, plain tier on
    the CPU) against jax.grad of flash_attention_pallas with bf16 K/V: dQ
    within 1e-5 * max; the group-summed bf16 dK / dV within one ulp, or
    n_rep ulps at max|.|: each of the n_rep per-head terms may sit one of its
    own ulps off (held per head above), and two terms that cancel leave that
    on a small sum (measured: 0.00195, one ulp of a term near 0.3, on a sum
    far smaller, at n_rep 2)."""
    b, hq, hkv, tq, s, kv_len, q_off = geom
    q, k, v, do = _inputs(b, hq, hkv, tq, s, seed=sum(geom) + 1)

    def jf(q_, k_, v_):
        return jnp.sum(jnp.sin(flash_attention_pallas(q_, k_, v_, kv_len=kv_len,
                                                      q_offset=q_off)))

    jg = jax.grad(jf, argnums=(0, 1, 2))(jnp.asarray(q), _jnp_bf16(k), _jnp_bf16(v))
    tq_ = torch.from_numpy(q).requires_grad_()
    tk, tv = k.clone().requires_grad_(), v.clone().requires_grad_()
    global_profile.reset()
    o = dispatch.flash_attention(tq_, tk, tv, kv_len=kv_len, q_offset=q_off)
    torch.sum(torch.sin(o)).backward()
    assert global_profile.tier_summary() == {"flash_fwd": {"ref": 1}, "flash_dq": {"ref": 1},
                                             "flash_dkv": {"ref": 1}}
    _assert_rel(tq_.grad.numpy(), np.asarray(jg[0]), 1e-5, "dq")
    assert tk.grad.dtype == torch.bfloat16
    for name, got, want in (("dk", tk.grad, jg[1]), ("dv", tv.grad, jg[2])):
        want = _np(want)
        floor = hq // hkv * float(ulp_bf16(np.max(np.abs(want)))) / np.max(np.abs(want))
        _assert_ulps(got.float().numpy(), want, name, floor_rel=floor)


@pytest.mark.parametrize("geom", GEOMETRIES[1:])
def test_attention_switched_off_trains_the_plain_attention(geom, monkeypatch):
    """With attention switched off (ZGML_TPU_KERNELS_DISABLE=attention, set
    around both packages; ROADMAP C.3) training's attention is the plain one
    differentiated by autograd, as the JAX package's ref tier under jax.grad
    (zgml_tpu/ops/dispatch.py:173-190), not K10: no flash_fwd / flash_dq /
    flash_dkv placement, dQ within 1e-5 * max and the bf16 dK / dV within the
    group-sum bound above of jax.grad through the JAX dispatch."""
    from zgml_tpu.ops import dispatch as jdispatch
    monkeypatch.setenv("ZGML_TPU_KERNELS_DISABLE", "attention")
    b, hq, hkv, tq, s, kv_len, q_off = geom
    q, k, v, do = _inputs(b, hq, hkv, tq, s, seed=sum(geom) + 2)

    def jf(q_, k_, v_):
        return jnp.sum(jnp.sin(jdispatch.flash_attention(q_, k_, v_, kv_len=kv_len,
                                                         q_offset=q_off)))

    jg = jax.grad(jf, argnums=(0, 1, 2))(jnp.asarray(q), _jnp_bf16(k), _jnp_bf16(v))
    tq_ = torch.from_numpy(q).requires_grad_()
    tk, tv = k.clone().requires_grad_(), v.clone().requires_grad_()
    global_profile.reset()
    o = dispatch.flash_attention(tq_, tk, tv, kv_len=kv_len, q_offset=q_off)
    torch.sum(torch.sin(o)).backward()
    assert global_profile.tier_summary() == {"attention": {"ref": 1}}
    _assert_rel(tq_.grad.numpy(), np.asarray(jg[0]), 1e-5, "dq")
    assert tk.grad.dtype == torch.bfloat16
    for name, got, want in (("dk", tk.grad, jg[1]), ("dv", tv.grad, jg[2])):
        want = _np(want)
        floor = hq // hkv * float(ulp_bf16(np.max(np.abs(want)))) / np.max(np.abs(want))
        _assert_ulps(got.float().numpy(), want, name, floor_rel=floor)


def test_group_sum_rounds_once():
    """XLA sums the bf16 group in f32 and rounds once (checked against
    jnp.sum of a bf16 array); group_sum does the same."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 8, 64, 64)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = jnp.asarray(x).astype(jnp.bfloat16).reshape(1, 2, 4, 64, 64).sum(axis=2)
    np.testing.assert_array_equal(group_sum(xb, 2).float().numpy(), _np(want))
