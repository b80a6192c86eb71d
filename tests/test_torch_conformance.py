"""The port's conformance sweep (zgml_tpu_torch/runtime/conformance.py) on the
CPU, against the JAX package's run_conformance.

On the CPU both sides of every entry are plain versions, so every entry is
`ok` (rel_err 0 where both run one function). Its entry names are JAX's at
the same dims: under ZGML_TPU_KERNELS=ref on both sides (the JAX sweep then
runs its XLA tier, fast here, and neither side has the fused FFN entries),
and at the default flags JAX's names plus the two fused FFN entries exactly
where JAX's layer takes them (its pair kernel's ffn_compatible, its
attach_head_major's N-packed view), checked on JAX's own synthesized layer.
Each result carries the placement of its kernel call alone.
"""
import dataclasses

import numpy as np
import pytest

from zgml_tpu.ops.ffn import ffn_compatible
from zgml_tpu.runtime import conformance as jconf

from zgml_tpu_torch.models.llama import LlamaConfig
from zgml_tpu_torch.runtime.conformance import render, run_conformance

CFG = LlamaConfig(vocab_size=96, d_model=512, n_heads=8, n_kv_heads=2, d_ff=1024, n_layers=2,
                  max_seq_len=512)
DIMS = {"d512": CFG, "d256": dataclasses.replace(CFG, d_model=256, d_ff=512)}
FFN_NAMES = ("fused_ffn_norm", "fused_ffn_norm_q4n")


@pytest.fixture(params=list(DIMS))
def cfg(request):
    return DIMS[request.param]


def _jax_ffn_entries(cfg) -> tuple[str, ...]:
    """The fused FFN entries JAX's sweep has at the default flags: its pair
    kernel where ffn_compatible holds, its N-packed kernel where
    attach_head_major attached the view, on its own layer."""
    layer = jconf._mk_layer(cfg, "q4_0", np.random.default_rng(0))
    return tuple(n for n, on in zip(FFN_NAMES, (ffn_compatible(layer["w_gate_up"],
                                                               layer["w_down"]),
                                                "ffn_q4n" in layer)) if on)


def test_conformance_names_match_jax(cfg, monkeypatch):
    monkeypatch.setenv("ZGML_TPU_KERNELS", "ref")
    want = [r["name"] for r in jconf.run_conformance(cfg, kv_len=64)]
    ref = run_conformance(cfg, kv_len=64, device="cpu")
    assert [r["name"] for r in ref] == want
    assert not set(FFN_NAMES) & set(want)
    monkeypatch.delenv("ZGML_TPU_KERNELS")
    got = run_conformance(cfg, kv_len=64, device="cpu")
    at = want.index("qmatmul_q4_0_gemm_m128") + 1
    assert [r["name"] for r in got] == want[:at] + list(_jax_ffn_entries(cfg)) + want[at:]
    assert (cfg.d_model == 512) == bool(_jax_ffn_entries(cfg))


def test_conformance_all_ok_on_the_cpu(cfg):
    res = run_conformance(cfg, kv_len=64, device="cpu")
    text = render(res)
    assert all(r["ok"] for r in res), text
    assert f"{len(res)}/{len(res)} passed" in text
    # each entry's call was placed, on the plain tier here
    assert all(r["placement"] and all("ref" in t or "torch" in t
                                      for t in r["placement"].values()) for r in res)
