"""K5 (the greedy head) at a K where K1's plan takes its K-split form
(ops/qmatmul.i8_plan, kc > 1: Q8_0 rows from K 27,040, Q4_0 from 51,072):
the port against the JAX package on the CPU.

The JAX `_q8_i8_argmax_kernel` / `_q4_i8_argmax_kernel` walk K in blocks of
their grid (zgml_tpu/ops/qmatmul.py:425-480), so they take any K; the JAX
side runs in interpret mode (tests/conftest.py). Both quantize one numpy
weight with their GGUF codecs (the same bytes) and take one numpy row. The
port's greedy id on the CPU (its plain version, dispatch.qmatmul_greedy)
equals JAX's qmatmul_greedy id exactly, and equals argmax of the port's K1
plain output; the card's K-split kernel is held to argmax of K1's split
output in tests/test_torch_kernels_wide.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zgml_tpu.ops import dispatch as jdispatch
from zgml_tpu.quant.repack import quantize_weight as jax_quantize_weight

from zgml_tpu_torch.io.llama_loader import quantize_weight
from zgml_tpu_torch.ops import dispatch
from zgml_tpu_torch.ops.qmatmul import i8_plan, qmatmul_i8_ref
from zgml_tpu_torch.runtime.profile import global_profile

H100_SMS = 132


@pytest.mark.parametrize("kind,n,k,seed", [("q8_0", 256, 28672, 0), ("q8_0", 96, 27040, 1),
                                           ("q4_0", 128, 51072, 2)])
def test_greedy_on_the_k_split_plan_matches_jax(kind, n, k, seed):
    assert i8_plan(1, n, k, kind, H100_SMS).kc > 1
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n, k)) * 0.05).astype(np.float32)
    x = rng.standard_normal((1, k)).astype(np.float32)
    want = jdispatch.qmatmul_greedy(jnp.asarray(x), jax_quantize_weight(w, kind))
    assert want is not None
    pw = quantize_weight(w, kind, "cpu")
    global_profile.reset()
    got = dispatch.qmatmul_greedy(torch.from_numpy(x), pw)
    assert global_profile.tier_summary() == {
        "qmatmul_greedy" + ("_q8" if kind == "q8_0" else ""): {"ref": 1}}
    assert int(got[0]) == int(np.asarray(want).reshape(-1)[0])
    assert int(got[0]) == int(torch.argmax(qmatmul_i8_ref(torch.from_numpy(x), pw)[0]))
