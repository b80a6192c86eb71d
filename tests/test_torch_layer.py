"""K7 attn_block: the port's plain version against the JAX package's layer
kernel (`attn_block_step(..., kv_layer=li)`, interpret mode, f32 A phase) on
a stacked bf16 cache.

Both sides get the same Q4_0 wqkv / wo (the port's converted from the JAX
planar weights), the same x and the same bf16 cache values. Compared: x_out,
and the rotated k_cur and v_cur, within 1e-5 * max|out| (f32 on both sides,
sums in another order); the port also writes the bf16 K/V at row pos of
layer li in place, which must hold bf16(k_cur) / bf16(v_cur) and leave every
other row as it was.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zgml_tpu.models.llama import LlamaConfig as JaxConfig
from zgml_tpu.ops import refs as jrefs
from zgml_tpu.ops.layerkernel import attn_block_step
from zgml_tpu.quant.headmajor import attach_head_major
from zgml_tpu.quant.repack import concat_packed, quantize_weight

from zgml_tpu_torch.ops import dispatch, refs
from zgml_tpu_torch.ops.layerkernel import attn_block_compatible
from zgml_tpu_torch.quant import packed
from zgml_tpu_torch.runtime.profile import global_profile

torch.set_num_threads(1)

HQ, HKV, HD, L, S = 8, 2, 32, 2, 64


def _cfg(hq, hkv, hd):
    return JaxConfig(vocab_size=128, d_model=hq * hd, n_heads=hq, n_kv_heads=hkv, d_ff=128,
                     n_layers=L, max_seq_len=S)


def _layer(rng, hq, hkv, hd):
    d = hq * hd

    def qw(n, k, **kw):
        return quantize_weight(rng.standard_normal((n, k)).astype(np.float32) * 0.08,
                               "q4_0", **kw)
    wqkv = concat_packed([qw(hq * hd, d, n_align=1), qw(hkv * hd, d, n_align=1),
                          qw(hkv * hd, d, n_align=1)])
    layer = {"wqkv": wqkv, "wo": qw(d, hq * hd),
             "attn_norm": (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)}
    assert attach_head_major(layer, hq, hkv, hd)
    return layer


@pytest.mark.parametrize("pos", [0, 1, 37])
def test_attn_block_plain_matches_jax_kernel(monkeypatch, pos):
    _check_against_jax(monkeypatch, pos, HQ, HKV, HD)


def test_attn_block_plain_matches_jax_kernel_head_dim_96(monkeypatch):
    """A head_dim that is a multiple of 32 but not a power of two."""
    _check_against_jax(monkeypatch, 37, 4, 2, 96)


def _check_against_jax(monkeypatch, pos, hq, hkv, hd):
    monkeypatch.setenv("ZGML_TPU_SCALES", "f16")
    rng = np.random.default_rng(100 + pos)
    cfg = _cfg(hq, hkv, hd)
    layer = _layer(rng, hq, hkv, hd)
    li = 1
    x = rng.standard_normal((1, 1, cfg.d_model)).astype(np.float32)
    ck = torch.from_numpy(rng.standard_normal((L, 1, hkv, S, hd)).astype(np.float32) * 0.5
                          ).bfloat16()
    cv = torch.from_numpy(rng.standard_normal((L, 1, hkv, S, hd)).astype(np.float32) * 0.5
                          ).bfloat16()
    cos, sin = jrefs.rope_cos_sin(jnp.asarray([pos]), hd, cfg.rope_base)
    c2, s2 = jnp.concatenate([cos, cos], axis=1), jnp.concatenate([-sin, sin], axis=1)
    jx, jk, jv, did_ffn, _, _ = attn_block_step(
        cfg, layer, jnp.asarray(x), jnp.asarray(ck.float().numpy(), jnp.bfloat16),
        jnp.asarray(cv.float().numpy(), jnp.bfloat16), pos, c2, s2, kv_layer=li)
    assert not did_ffn

    wqkv, wo = layer["wqkv"], layer["wo"]
    pcos, psin = refs.rope_cos_sin(torch.tensor([pos]), hd, cfg.rope_base)
    ck0, cv0 = ck.clone(), cv.clone()
    global_profile.reset()
    xo, kc, vc = dispatch.attn_block(
        torch.from_numpy(x), torch.from_numpy(layer["attn_norm"]),
        packed.from_planar_q4_0(wqkv.qvals, wqkv.scales, wqkv.n, wqkv.k),
        packed.from_planar_q4_0(wo.qvals, wo.scales, wo.n, wo.k), ck, cv, li,
        torch.tensor([pos], dtype=torch.int32), pcos, psin, hq, hkv, cfg.rms_norm_eps)
    assert global_profile.tier_summary() == {"attn_block": {"ref": 1}}
    for got, want in ((xo, jx), (kc, jk), (vc, jv)):
        want = np.asarray(want)
        assert got.shape == want.shape
        assert np.max(np.abs(got.numpy() - want)) <= 1e-5 * np.max(np.abs(want))
    assert torch.equal(ck[li, 0, :, pos], kc[0, :, 0].bfloat16())
    assert torch.equal(cv[li, 0, :, pos], vc[0, :, 0].bfloat16())
    rows = torch.arange(S) != pos
    assert torch.equal(ck[li, :, :, rows], ck0[li, :, :, rows])
    assert torch.equal(cv[li, :, :, rows], cv0[li, :, :, rows])
    assert torch.equal(ck[1 - li], ck0[1 - li]) and torch.equal(cv[1 - li], cv0[1 - li])


def test_attn_block_compatible_follows_the_jax_rule():
    assert all(attn_block_compatible(hd, 1) for hd in (32, 64, 96, 128, 160, 256))
    assert not attn_block_compatible(16, 1)        # head_dim < 32 (TINY_TEST)
    assert not attn_block_compatible(80, 1)        # not a multiple of 32
    assert not attn_block_compatible(64, 2)        # batch > 1
    assert not attn_block_compatible(288, 1)       # past the compiled head dims (JAX: K7)
