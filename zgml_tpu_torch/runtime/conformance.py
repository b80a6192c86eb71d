"""Conformance sweep on the device: every hot kernel against its plain version
at a model's dims, through the port's dispatch.

Counterpart of zgml_tpu/runtime/conformance.py:64-189, with its entries, in
its order, its inputs drawn in its order from one numpy generator, and its
tolerances (matmul-shaped ops 2e-2 or 3e-2 relative to max|plain|, the norm
1e-4). Each entry runs the call the model makes (`got`) and the same call
under dispatch.force_ref() (`want`, the plain versions on the same device;
the FFN entries against the f32 composition of rmsnorm and two f32
projections, JAX's ref tier):

  qmatmul_{kind}_gemv_m1 / _gemm_m128   K1 (one row) / K2 (128 rows), each kind
  fused_ffn_norm          Q4_0: K6d, JAX's f32 pair kernel (ZGML_TPU_FFN_I8A
                          held at 0 for the call)
  fused_ffn_norm_q4n      Q4_0: the N-packed FFN as the model's decode calls
                          it (dispatch.fused_ffn_norm: K6d, or K6c where
                          ZGML_TPU_FFN_I8A holds at the padded width)
  rmsnorm                 K12 under config.force_kernels("rmsnorm")
  flash_attention_pp128   K3 over f32 K / V, 128 queries after kv_len keys
  decode_attention        K4 over the bf16 cache
  decode_attention_q8     K8 over the int8 cache
  flash_attention_q8_pp128  K9
  attn_block_layer / attn_block_kv_write   K7 through models/llama._fused_layer
                          (with the FFN after it), its output and its row pos

The two FFN entries exist where JAX's do: its pair kernel where the padded d
is a multiple of 512 and at most 8192 (ffn_compatible), its N-packed view
where head_dim is a multiple of 32 (attach_head_major) and the padded d a
multiple of 512. Weights are quantized from f32 with
io/llama_loader.quantize_weight, the GGUF codecs' bytes. Each result also
carries `placement`, the placement counters of its `got` call alone
(runtime/profile.py), so a run on the card can show that every entry ran
its kernel (`cuda`) and no plain version.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import os

import numpy as np
import torch

from zgml_tpu_torch import config
from zgml_tpu_torch.io.llama_loader import quantize_weight
from zgml_tpu_torch.models.llama import LlamaConfig, _fused_layer
from zgml_tpu_torch.ops import dispatch as ops
from zgml_tpu_torch.ops import ffn, refs
from zgml_tpu_torch.quant import kv_cache, packed
from zgml_tpu_torch.quant.packed import resolve_device
from zgml_tpu_torch.runtime.profile import global_profile


def _rel_err(got, want) -> float:
    got = got.detach().to("cpu", torch.float32).numpy()
    want = want.detach().to("cpu", torch.float32).numpy()
    scale = max(float(np.max(np.abs(want))), 1e-6)
    return float(np.max(np.abs(got - want))) / scale


@contextlib.contextmanager
def _env(name: str, value: str):
    saved = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = saved


def _mk_layer(cfg: LlamaConfig, kind: str, rng, dev) -> dict:
    """One synthesized layer, drawn in the JAX `_mk_layer` order."""
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd

    def qw(n, k):
        w = rng.standard_normal((n, k)).astype(np.float32) * 0.05
        return quantize_weight(w, kind, dev)

    wqkv = packed.concat([qw(nq, d), qw(nkv, d), qw(nkv, d)])
    wd = qw(d, cfg.d_ff)
    wgu = packed.concat([qw(cfg.d_ff, d), qw(cfg.d_ff, d)])
    wo = qw(d, nq)

    def norm():
        return torch.from_numpy(1.0 + 0.1 * rng.standard_normal(d).astype(np.float32)).to(dev)
    return {"wqkv": wqkv, "wo": wo, "w_gate_up": wgu, "w_down": wd, "attn_norm": norm(),
            "ffn_norm": norm()}


def _pair_ffn(cfg: LlamaConfig) -> bool:
    """JAX's pair kernel takes the layer (ffn_compatible on its padded Q4_0
    widths)."""
    return ffn.ffn_fuses(cfg.d_model, cfg.d_ff, "q4_0", after_attn_block=False)


def _npacked_ffn(cfg: LlamaConfig) -> bool:
    """JAX attaches the N-packed FFN view (attach_head_major, ffn_npack)."""
    hd = cfg.head_dim
    return (hd % 32 == 0 and hd >= 32
            and ffn.ffn_fuses(cfg.d_model, cfg.d_ff, "q4_0", after_attn_block=True))


def run_conformance(cfg: LlamaConfig, kv_len: int = 192, seed: int = 0,
                    device="cuda") -> list[dict]:
    """[{name, rel_err, tol, ok, placement}] for every entry at cfg's dims,
    on `device` (the card unless named; on the CPU both sides are plain
    versions)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    d, hd = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    results: list[dict] = []

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    def run(fn):
        """fn() and the placement counts it added."""
        before = collections.Counter(global_profile.op_tiers)
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        added = collections.Counter(global_profile.op_tiers)
        added.subtract(before)
        place: dict[str, dict[str, int]] = {}
        for (op, tier), n in sorted(added.items()):
            if n:
                place.setdefault(op, {})[tier] = n
        return out, place

    def check(name, got, want, tol, place):
        err = _rel_err(got, want)
        results.append({"name": name, "rel_err": err, "tol": tol, "ok": bool(err <= tol),
                        "placement": place})

    for kind in ("q4_0", "q8_0"):
        layer = _mk_layer(cfg, kind, rng, dev)
        x1 = t(rng.standard_normal((1, 1, d)))
        xm = t(rng.standard_normal((1, 128, d)))
        for tag, xx in (("gemv_m1", x1), ("gemm_m128", xm)):
            got, place = run(lambda: ops.qmatmul(xx, layer["wqkv"]))
            with ops.force_ref():
                want = ops.qmatmul(xx, layer["wqkv"])
            check(f"qmatmul_{kind}_{tag}", got, want, 2e-2, place)
        if kind == "q4_0" and config.kernel_on("fused_ffn"):
            # the f32 composition (JAX's ref tier: f32 dequant projections)
            g = layer["ffn_norm"]
            gu = refs.qmatmul_ref(refs.rmsnorm(x1, g, cfg.rms_norm_eps), layer["w_gate_up"])
            f = gu.shape[-1] // 2
            want = x1 + refs.qmatmul_ref(refs.swiglu(gu[..., :f], gu[..., f:]),
                                         layer["w_down"])
            args = (x1, g, layer["w_gate_up"], layer["w_down"], cfg.rms_norm_eps)
            if _pair_ffn(cfg):
                with _env("ZGML_TPU_FFN_I8A", "0"):
                    got, place = run(lambda: ops.fused_ffn_norm(*args))
                check("fused_ffn_norm", got, want, 2e-2, place)
            if _npacked_ffn(cfg):
                got, place = run(lambda: ops.fused_ffn_norm(*args))
                check("fused_ffn_norm_q4n", got, want, 2e-2, place)

    with config.force_kernels("rmsnorm"):
        g = t(1.0 + 0.1 * rng.standard_normal(d))
        xx = t(rng.standard_normal((1, 8, d)))
        got, place = run(lambda: ops.rmsnorm(xx, g, 1e-5))
        check("rmsnorm", got, refs.rmsnorm(xx, g, 1e-5), 1e-4, place)

    s_len = max(kv_len + 129, 256)
    q1 = t(rng.standard_normal((1, hq, 1, hd)) * 0.3)
    qm = t(rng.standard_normal((1, hq, 128, hd)) * 0.3)
    kc = t(rng.standard_normal((1, hkv, s_len, hd)) * 0.3)
    vc = t(rng.standard_normal((1, hkv, s_len, hd)) * 0.3)

    def twice(name, fn, tol):
        got, place = run(fn)
        with ops.force_ref():
            want = fn()
        check(name, got, want, tol, place)
    twice("flash_attention_pp128",
          lambda: ops.flash_attention(qm, kc, vc, kv_len=kv_len + 128, q_offset=kv_len), 2e-2)
    kb, vb = kc.to(torch.bfloat16), vc.to(torch.bfloat16)
    twice("decode_attention", lambda: ops.decode_attention(q1, kb, vb, kv_len), 2e-2)
    (kq, ks), (vq, vs) = kv_cache.quantize_columns(kc), kv_cache.quantize_columns(vc)
    twice("decode_attention_q8", lambda: ops.decode_attention_q8(q1, kq, ks, vq, vs, kv_len),
          3e-2)
    twice("flash_attention_q8_pp128",
          lambda: ops.flash_attention_q8(qm, kq, ks, vq, vs, kv_len=kv_len + 128,
                                         q_offset=kv_len), 3e-2)

    layer = _mk_layer(cfg, "q4_0", rng, dev)
    x1 = t(rng.standard_normal((1, 1, d)) * 0.3)
    cos, sin = refs.rope_cos_sin(torch.tensor([kv_len], device=dev), hd, cfg.rope_base)
    pos_t = torch.full((1,), kv_len, dtype=torch.int32, device=dev)
    lcfg = dataclasses.replace(cfg, n_layers=1)

    def layer_step():
        ck, cv = kb[None].clone(), vb[None].clone()      # [1, 1, hkv, S, hd]
        return _fused_layer(lcfg, x1, layer, ck, cv, 0, pos_t, cos, sin), ck
    (got_x, got_k), place = run(layer_step)
    with ops.force_ref():
        want_x, want_k = layer_step()
    check("attn_block_layer", got_x, want_x, 3e-2, place)
    check("attn_block_kv_write", got_k[0, 0, :, kv_len], want_k[0, 0, :, kv_len], 2e-2, place)
    return results


def render(results: list[dict]) -> str:
    lines = ["== conformance (kernels vs plain versions, this device) =="]
    for r in results:
        mark = "ok " if r["ok"] else "FAIL"
        lines.append(f"  {mark} {r['name']:28s} rel_err {r['rel_err']:.2e}"
                     f"  (tol {r['tol']:.0e})")
    n_ok = sum(r["ok"] for r in results)
    lines.append(f"  {n_ok}/{len(results)} passed")
    return "\n".join(lines)
