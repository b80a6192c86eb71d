"""K6d / K6a fused_ffn_norm: the port's plain version against the JAX
package's N-packed Q4_0 FFN kernel (`fused_ffn_norm_q4n`) and its planar
Q8_0 FFN kernel (`fused_ffn_norm_pallas`), interpret mode, f32 dequant.

Both sides get the same Q4_0 weights: the JAX side the pack that `ffn_npack`
derives from its planar part-padded w_gate_up and w_down, the port its own
w_gate_up [2F, D] / w_down [D, F] converted from the same planar weights on
the logical sizes. Bound 1e-5 * max|out|: both are f32 (rmsnorm, dequant
dots, SwiGLU, residual) and differ only in the order of the sums. The same
holds against JAX's planar fused FFN (K6b), which its `_layer_step` runs for
calls of <= 32 rows; and ffn_fuses must give JAX's own verdict on where it
fuses at all, at each kind. At Q8_0 the JAX package runs K6a for both the
fused decode and `_layer_step`, on w_gate_up part-padded to w_down's padded
K, as its loader fuses them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zgml_tpu.ops import dispatch as jdispatch
from zgml_tpu.ops.ffn import ffn_compatible, fused_ffn_norm_pallas, fused_ffn_norm_q4n
from zgml_tpu.quant.headmajor import attach_head_major, ffn_npack
from zgml_tpu.quant.repack import concat_packed, quantize_weight

from zgml_tpu_torch.ops import dispatch
from zgml_tpu_torch.ops.ffn import ffn_fuses
from zgml_tpu_torch.quant import packed
from zgml_tpu_torch.runtime.profile import global_profile

torch.set_num_threads(1)


def _port(pw, col0=0, n=None):
    build = packed.from_planar_q8_0 if pw.kind == "q8_0" else packed.from_planar_q4_0
    return build(pw.qvals, pw.scales, pw.n if n is None else n, pw.k, col0, device="cpu")


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
    assert ffn_fuses(d, f, "q4_0", after_attn_block=True) == ("ffn_q4n" in layer)
    assert ffn_fuses(d, f, "q4_0", after_attn_block=False) == ffn_compatible(layer["w_gate_up"], wd)


@pytest.mark.parametrize("m", [1, 16, 32])
def test_q8_fused_ffn_norm_plain_matches_jax_kernel(monkeypatch, m):
    """K6a at d 512 / F 1024: the JAX kernel `_ffn_kernel` through
    fused_ffn_norm_pallas (what `_ffn_after_attn` runs at Q8_0) against the
    port's plain version; within 1e-5 * max|out| (f32 on both sides)."""
    monkeypatch.setenv("ZGML_TPU_SCALES", "f16")
    d, f = 512, 1024
    rng = np.random.default_rng(200 + m)

    def qw(n, k, **kw):
        return quantize_weight(rng.standard_normal((n, k)).astype(np.float32) * 0.05,
                               "q8_0", **kw)
    wd = qw(d, f)
    gu = concat_packed([qw(f, d, n_align=1), qw(f, d, n_align=1)], part_pad=wd.k_pad)
    assert ffn_compatible(gu, wd)
    g = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    x = rng.standard_normal((1, m, d)).astype(np.float32)
    want = np.asarray(fused_ffn_norm_pallas(jnp.asarray(x), jnp.asarray(g), gu, wd, 1e-5))

    gu_p = packed.concat([_port(gu, 0, f), _port(gu, gu.n // 2, f)])
    global_profile.reset()
    got = dispatch.fused_ffn_norm(torch.from_numpy(x), torch.from_numpy(g), gu_p, _port(wd),
                                  1e-5).numpy()
    assert global_profile.tier_summary() == {"fused_ffn_norm_q8": {"ref": 1}}
    assert got.shape == want.shape == (1, m, d)
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))


@pytest.mark.parametrize("d,f", [(576, 256), (2048, 256), (4096, 256), (8192, 256),
                                 (9216, 256), (256, 256), (3200, 256), (2048, 320),
                                 (512, 1536)])
def test_q8_ffn_fuses_follows_ffn_compatible(monkeypatch, d, f):
    """At Q8_0 ffn_fuses gives ffn_compatible's verdict at both call sites
    (no N-packed view is attached, so `_ffn_after_attn` asks it too), on
    weights padded as the JAX loader pads them: the padded D capped at 8192
    (d 9216 composes) and w_down's padded K a multiple of 256 (F 320 pads to
    384 and composes)."""
    monkeypatch.setenv("ZGML_TPU_SCALES", "f16")
    rng = np.random.default_rng(d + f)

    def qw(n, k, **kw):
        return quantize_weight(rng.standard_normal((n, k)).astype(np.float32) * 0.05,
                               "q8_0", **kw)
    wd = qw(d, f)
    gu = concat_packed([qw(f, d, n_align=1), qw(f, d, n_align=1)], part_pad=wd.k_pad)
    want = ffn_compatible(gu, wd)
    assert want == (d <= 8192 and f != 320)
    assert ffn_fuses(d, f, "q8_0", after_attn_block=True) == want
    assert ffn_fuses(d, f, "q8_0", after_attn_block=False) == want
