"""K6d fused_ffn_norm: the port's plain version against the JAX package's
N-packed FFN kernel (`fused_ffn_norm_q4n`, interpret mode, f32 dequant).

Both sides get the same Q4_0 weights: the JAX side the pack that `ffn_npack`
derives from its planar part-padded w_gate_up and w_down, the port its own
w_gate_up [2F, D] / w_down [D, F] converted from the same planar weights on
the logical sizes. Bound 1e-5 * max|out|: both are f32 (rmsnorm, dequant
dots, SwiGLU, residual) and differ only in the order of the sums. The same
holds against JAX's planar fused FFN (K6b), which its `_layer_step` runs for
calls of <= 32 rows; and ffn_fuses must give JAX's own verdict on where it
fuses at all.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zgml_tpu.ops import dispatch as jdispatch
from zgml_tpu.ops.ffn import ffn_compatible, fused_ffn_norm_q4n
from zgml_tpu.quant.headmajor import attach_head_major, ffn_npack
from zgml_tpu.quant.repack import concat_packed, quantize_weight

from zgml_tpu_torch.ops import dispatch
from zgml_tpu_torch.ops.ffn import ffn_fuses
from zgml_tpu_torch.quant import packed
from zgml_tpu_torch.runtime.profile import global_profile

torch.set_num_threads(1)


def _port(pw, col0=0, n=None):
    return packed.from_planar_q4_0(pw.qvals, pw.scales, pw.n if n is None else n, pw.k, col0)


@pytest.mark.parametrize("d,f,m", [(512, 1024, 1), (512, 320, 3)])
def test_fused_ffn_norm_plain_matches_jax_kernel(monkeypatch, d, f, m):
    monkeypatch.setenv("ZGML_TPU_SCALES", "f16")
    rng = np.random.default_rng(d + f + m)

    def qw(n, k, **kw):
        return quantize_weight(rng.standard_normal((n, k)).astype(np.float32) * 0.05,
                               "q4_0", **kw)
    gate, up = qw(f, d, n_align=1), qw(f, d, n_align=1)
    wd = qw(d, f)
    gu = concat_packed([gate, up], part_pad=wd.k_pad)        # as the JAX loader fuses
    g = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    x = rng.standard_normal((m, 1, d)).astype(np.float32)
    want = np.asarray(fused_ffn_norm_q4n(jnp.asarray(x), jnp.asarray(g), ffn_npack(gu, wd),
                                         d, 1e-5))

    gu_p = packed.concat([_port(gu, 0, f), _port(gu, gu.n // 2, f)])
    global_profile.reset()
    got = dispatch.fused_ffn_norm(torch.from_numpy(x), torch.from_numpy(g), gu_p, _port(wd),
                                  1e-5).numpy()
    assert global_profile.tier_summary() == {"fused_ffn_norm": {"ref": 1}}
    assert got.shape == want.shape == (m, 1, d)
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))


def test_fused_ffn_norm_plain_matches_jax_layer_step_ffn(monkeypatch):
    """Calls of <= 32 rows outside the fused decode (a 16-row prefill chunk):
    JAX's `_layer_step` runs rmsnorm, its f32 fused FFN (K6b,
    `fused_ffn_pallas` through dispatch.fused_ffn) and the residual, where
    the port runs K6d. Same bound: f32 on both sides."""
    monkeypatch.setenv("ZGML_TPU_SCALES", "f16")
    d, f, m = 512, 1024, 16
    rng = np.random.default_rng(7)

    def qw(n, k, **kw):
        return quantize_weight(rng.standard_normal((n, k)).astype(np.float32) * 0.05,
                               "q4_0", **kw)
    wd = qw(d, f)
    gu = concat_packed([qw(f, d, n_align=1), qw(f, d, n_align=1)], part_pad=wd.k_pad)
    g = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    x = rng.standard_normal((1, m, d)).astype(np.float32)
    jx = jnp.asarray(x)
    ff = jdispatch.fused_ffn(jdispatch.rmsnorm(jx, jnp.asarray(g), 1e-5), gu, wd)
    assert ff is not None                               # JAX fuses at this width
    want = np.asarray(jx + ff)

    gu_p = packed.concat([_port(gu, 0, f), _port(gu, gu.n // 2, f)])
    got = dispatch.fused_ffn_norm(torch.from_numpy(x), torch.from_numpy(g), gu_p, _port(wd),
                                  1e-5).numpy()
    assert got.shape == want.shape == (1, m, d)
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))


@pytest.mark.parametrize("d", [256, 512, 576, 2048, 2560, 3200, 9216])
def test_ffn_fuses_follows_the_jax_padding(monkeypatch, d):
    """ffn_fuses gives the JAX package's own verdict on weights padded as its
    loader pads them: the N-packed view attach_head_major derives (the fused
    decode's K6d) and ffn_compatible (`_layer_step`'s K6b)."""
    monkeypatch.setenv("ZGML_TPU_SCALES", "f16")
    rng = np.random.default_rng(d)
    f, hd = 64, 32

    def qw(n, k, **kw):
        return quantize_weight(rng.standard_normal((n, k)).astype(np.float32) * 0.05,
                               "q4_0", **kw)
    wd = qw(d, f)
    layer = {"wqkv": concat_packed([qw(hd, d, n_align=1) for _ in range(3)]),
             "wo": qw(d, hd), "w_down": wd,
             "w_gate_up": concat_packed([qw(f, d, n_align=1), qw(f, d, n_align=1)],
                                        part_pad=wd.k_pad)}
    assert attach_head_major(layer, 1, 1, hd)
    assert ffn_fuses(d, after_attn_block=True) == ("ffn_q4n" in layer)
    assert ffn_fuses(d, after_attn_block=False) == ffn_compatible(layer["w_gate_up"], wd)
