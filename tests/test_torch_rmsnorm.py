"""K12's plain version and its routing against the JAX package.

The JAX side runs `rmsnorm_pallas` (Pallas interpret mode, tests/conftest.py),
which pads rows to 8 and d to 128 lanes and divides by the logical d; d 100
exercises that padding. Tolerances: the forward within 2e-6 * max|out| (f32
sums of squares in another order), the gradients of x and gamma through
rmsnorm.RMSNorm (plain recompute) within 1e-5 * max|g| of jax.grad through
the custom VJP (the same recompute, sums in another order).

K12's design, held here before the card sees it: ``rmsnorm_plan`` covers
every row once (each vector by one thread of one block, at most 4 vectors a
thread, threads a multiple of 32 up to 1024, the scalar loop exactly where
d is not a multiple of the 16-byte vector width or an operand is not
aligned), and a numpy emulation of the kernel's f32 summation order (each
thread over its vectors, the warp's xor shuffle tree, the warps' sums in
order) stays within 2e-6 * max|out| of
refs.rmsnorm and of the JAX kernel.

Routing: ZGML_TPU_KERNELS_FORCE=rmsnorm sends ops.dispatch.rmsnorm to K12 on
the card; on the CPU the call runs the plain version counted under `ref`,
and without the flag plain torch counted under `torch`, as the JAX package
counts its XLA tier. A d 512 Q4_0 llama under the flag (prefill through
`_layer_step`, whose two norms per layer are K12's, and the head's out_norm)
gives the JAX package's logits under the same flag: the prefill within
1e-3 * max|logit| (bf16 cache rounding, PERF.md) and each decode step from
the JAX cache of that step within 1e-5 * max|logit|.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from zgml_tpu.io.llama_loader import load_llama as jax_load_llama
from zgml_tpu.ops.rmsnorm import rmsnorm_pallas
from zgml_tpu.runtime.engine import LlamaEngine as JaxEngine

from zgml_tpu_torch import config
from zgml_tpu_torch.io.gguf import GGMLType
from zgml_tpu_torch.io.llama_loader import load_llama
from zgml_tpu_torch.models.llama import LlamaConfig
from zgml_tpu_torch.ops import dispatch
from zgml_tpu_torch.ops.rmsnorm import RMSNorm, VPT_MAX, rmsnorm_plan, rmsnorm_ref
from zgml_tpu_torch.runtime.engine import LlamaEngine
from zgml_tpu_torch.runtime.profile import global_profile
from zgml_tpu_torch.utils.synthetic import write_synthetic_llama_gguf

torch.set_num_threads(1)
FWD_RTOL, GRAD_RTOL, STEP_RTOL = 2e-6, 1e-5, 1e-5


def _inputs(m, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, d)).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    return x, g


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    assert float(np.max(np.abs(got - want))) <= rtol * float(np.max(np.abs(want)))


@pytest.mark.parametrize("d", [64, 100, 2048])
@pytest.mark.parametrize("m", [1, 7, 128])
def test_plain_matches_jax_kernel(m, d):
    x, g = _inputs(m, d, m * 1000 + d)
    want = rmsnorm_pallas(jnp.asarray(x), jnp.asarray(g), 1e-5)
    got = rmsnorm_ref(torch.from_numpy(x), torch.from_numpy(g), 1e-5)
    assert got.dtype == torch.float32
    _close(got.numpy(), want, FWD_RTOL)


H100_SMS = 132


def _vector_indices(plan, d):
    """Per thread of a row: the vectors (scalar path: values) it holds, as
    csrc/rmsnorm.cu indexes them."""
    n = d // plan.width
    return {t: [i for r in range(plan.vpt) if (i := r * plan.threads + t) < n]
            for t in range(plan.threads)}


@pytest.mark.parametrize("m", [1, 128, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [1, 31, 64, 100, 2048, 4096, 5632, 8192])
def test_plan_covers_each_row_once(d, dtype, m):
    plan = rmsnorm_plan(m, d, dtype, H100_SMS)
    width = 16 // dtype.itemsize
    assert plan.vector == (d % width == 0)
    assert plan.width == (width if plan.vector else 1)
    assert 1 <= plan.vpt <= VPT_MAX
    assert plan.threads % 32 == 0 and plan.threads * plan.rows <= 1024
    assert plan.rows == 1 or plan.threads == 32
    held = _vector_indices(plan, d)
    got = sorted(i for v in held.values() for i in v)
    assert got == list(range(d // plan.width))
    assert plan.blocks * plan.rows >= m
    assert (plan.blocks - 1) * plan.rows < m


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [4096, 5632, 8192, 16384])
def test_plan_gives_a_wide_row_one_block_of_the_fewest_threads(d, dtype):
    """A row wider than one warp's 4 vectors a thread takes one block, of
    the fewest whole warps that hold it in at most 4 vectors a thread."""
    plan = rmsnorm_plan(1, d, dtype, H100_SMS)
    nvec = d // (16 // dtype.itemsize)
    assert plan.vector and plan.rows == 1 and plan.blocks == 1
    assert plan.threads * VPT_MAX >= nvec > (plan.threads - 32) * VPT_MAX
    assert (plan.vpt - 1) * plan.threads < nvec <= plan.vpt * plan.threads


def test_plan_takes_the_scalar_loop_where_unaligned():
    plan = rmsnorm_plan(128, 2048, torch.float32, H100_SMS, aligned=False)
    assert not plan.vector and plan.width == 1 and plan.blocks == 128


def _warp_tree(lanes):
    """csrc/common.cuh warp_sum: v += shfl_xor(v, off), off 16 .. 1, in f32
    (every lane ends with the same bits); lane 0's value."""
    v = np.asarray(lanes, np.float32)
    for off in (16, 8, 4, 2, 1):
        v = (v + v[np.arange(32) ^ off]).astype(np.float32)
    return v[0]


def _emulate_k12(x, g, eps, plan):
    """csrc/rmsnorm.cu's vector path in numpy f32: each thread's sum of
    squares over its vectors in order, the warp tree, then (a row in a block)
    the warps' sums in order; ms = sum / d, rsqrt, x * inv, then * gamma."""
    m, d = x.shape
    held = _vector_indices(plan, d)
    out = np.empty_like(x)
    for row in range(m):
        sq = (x[row] * x[row]).astype(np.float32).reshape(-1, plan.width)
        ss = []
        for t in range(plan.threads):
            acc = np.float32(0)
            for i in held[t]:
                for v in sq[i]:
                    acc = np.float32(acc + v)
            ss.append(acc)
        warps = [_warp_tree(ss[w:w + 32]) for w in range(0, plan.threads, 32)]
        total = np.float32(0)
        for w in warps:
            total = np.float32(total + w)
        ms = np.float32(total / np.float32(d))
        inv = np.float32(1 / np.sqrt(np.float64(np.float32(ms + np.float32(eps)))))
        out[row] = (x[row] * inv).astype(np.float32) * g
    return out


@pytest.mark.parametrize("d", [512, 2048, 4096])
def test_kernel_summation_order_matches_refs_and_jax(d):
    x, g = _inputs(3, d, d + 1)
    plan = rmsnorm_plan(3, d, torch.float32, H100_SMS)
    assert plan.vector
    got = _emulate_k12(x, g, 1e-5, plan)
    _close(got, rmsnorm_ref(torch.from_numpy(x), torch.from_numpy(g), 1e-5).numpy(), FWD_RTOL)
    _close(got, rmsnorm_pallas(jnp.asarray(x), jnp.asarray(g), 1e-5), FWD_RTOL)


@pytest.mark.parametrize("shape", [(7, 100), (2, 3, 64)])
def test_gradients_match_jax_vjp(shape):
    """d/dx and d/dgamma of sum(rmsnorm(x, gamma) * w)."""
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    w = rng.standard_normal(shape).astype(np.float32)
    jgx, jgg = jax.grad(lambda x_, g_: jnp.sum(rmsnorm_pallas(x_, g_, 1e-5) * w),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    gt = torch.from_numpy(g).requires_grad_()
    global_profile.reset()
    out = RMSNorm.apply(xt, gt, 1e-5, False)
    pgx, pgg = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (xt, gt))
    assert global_profile.tier_summary() == {"rmsnorm": {"ref": 1},
                                             "rmsnorm_bwd": {"torch": 1}}
    _close(pgx.numpy(), jgx, GRAD_RTOL)
    _close(pgg.numpy(), jgg, GRAD_RTOL)


@pytest.mark.parametrize("force,disable,tier", [("", "", "torch"), ("rmsnorm", "", "ref"),
                                                ("rmsnorm", "rmsnorm", "torch"),
                                                ("attention", "", "torch")])
def test_routing_follows_the_flags(monkeypatch, force, disable, tier):
    """The plain value on every route (the CPU has no kernel); the count
    says which route: `ref` where the flag asks for K12, `torch` else."""
    monkeypatch.setenv("ZGML_TPU_KERNELS_FORCE", force)
    monkeypatch.setenv("ZGML_TPU_KERNELS_DISABLE", disable)
    x, g = (torch.from_numpy(a) for a in _inputs(5, 64, 1))
    global_profile.reset()
    out = dispatch.rmsnorm(x, g, 1e-5)
    torch.testing.assert_close(out, rmsnorm_ref(x, g, 1e-5), rtol=0, atol=0)
    assert global_profile.tier_summary() == {"rmsnorm": {tier: 1}}


def test_routing_under_autograd_and_force_kernels(monkeypatch):
    """Under the flag and autograd the call goes through RMSNorm (its
    backward counted as rmsnorm_bwd); config.force_kernels sets the flag for
    a block only."""
    monkeypatch.delenv("ZGML_TPU_KERNELS_FORCE", raising=False)
    monkeypatch.delenv("ZGML_TPU_KERNELS_DISABLE", raising=False)
    x = torch.randn(3, 64, requires_grad=True)
    g = torch.ones(64)
    global_profile.reset()
    with config.force_kernels("rmsnorm"):
        assert config.kernels_forced() == {"rmsnorm"}
        out = dispatch.rmsnorm(x, g)
    assert config.kernels_forced() == frozenset()
    out.sum().backward()
    assert x.grad is not None and global_profile.tier_summary() == {
        "rmsnorm": {"ref": 1}, "rmsnorm_bwd": {"torch": 1}}


DEFAULT_CFG = LlamaConfig(vocab_size=96, d_model=512, n_heads=8, n_kv_heads=2, d_ff=1024,
                          n_layers=2, max_seq_len=96)
FLAGS = {"ZGML_TPU_SCALES": "f16", "ZGML_TPU_PREFILL_BF16": "0",
         "ZGML_TPU_KERNELS_FORCE": "rmsnorm"}
CLEARED = ("ZGML_TPU_ATTN_BLOCK", "ZGML_TPU_KERNELS_DISABLE", "ZGML_TPU_I8DOT",
           "ZGML_TPU_ATTN_I8A", "ZGML_TPU_FFN_I8A", "ZGML_TPU_LAYER_FFN")
PROMPT_LEN, CHUNK, N_STEPS = 20, 64, 4


@pytest.fixture(scope="module")
def forced_runs(tmp_path_factory):
    """Both packages under ZGML_TPU_KERNELS_FORCE=rmsnorm on one Q4_0 d 512
    GGUF: the prefill logits, then N_STEPS step() logits, each step of the
    port from the JAX cache of that step."""
    path = str(tmp_path_factory.mktemp("torch_rmsnorm") / "d512_q4.gguf")
    write_synthetic_llama_gguf(path, DEFAULT_CFG, quant=GGMLType.Q4_0, seed=21)
    prompt = np.random.default_rng(8).integers(0, DEFAULT_CFG.vocab_size, PROMPT_LEN)
    with pytest.MonkeyPatch.context() as mp:
        for k in CLEARED:
            mp.delenv(k, raising=False)
        for k, v in FLAGS.items():
            mp.setenv(k, v)
        jmodel, jgf = jax_load_llama(path)
        jgf.close()
        jeng = JaxEngine(jmodel, prefill_chunk=CHUNK)
        jlogits = np.asarray(jeng.prefill(prompt))[0]
        feed, jstep, jcaches = [int(np.argmax(jlogits))], [], []
        for _ in range(N_STEPS):
            jcaches.append({k: np.array(jeng.cache[k].astype(np.float32)) for k in ("k", "v")})
            nxt, lg = jeng.step(np.array(feed[-1:], np.int32))
            jstep.append(np.asarray(lg)[0])
            feed.append(int(np.asarray(nxt)[0]))

        pmodel, pgf = load_llama(path, device="cpu")
        pgf.close()
        global_profile.reset()
        peng = LlamaEngine(pmodel, prefill_chunk=CHUNK)
        plogits = peng.prefill(prompt)[0].numpy()
        pstep = []
        for t, cache in zip(feed, jcaches):
            for k in ("k", "v"):
                peng.cache[k].copy_(torch.from_numpy(cache[k]).to(torch.bfloat16))
            pstep.append(peng.step(torch.tensor([t]))[1][0].numpy())
        tiers = global_profile.tier_summary()
    return {"jax": (jlogits, jstep), "port": (plogits, pstep), "tiers": tiers,
            "cfg": dataclasses.replace(DEFAULT_CFG)}


def test_forced_llama_prefill_matches_jax(forced_runs):
    _close(forced_runs["port"][0], forced_runs["jax"][0], 1e-3)


def test_forced_llama_steps_match_jax(forced_runs):
    for got, want in zip(forced_runs["port"][1], forced_runs["jax"][1]):
        _close(got, want, STEP_RTOL)


def test_forced_llama_counts_k12_at_every_norm(forced_runs):
    """Two norms per layer of the prefill chunk and one per head call (the
    prefill and each step) take the K12 route, counted under `ref` on the
    CPU; the decode layers' norms stay inside K7 and K6."""
    cfg, tiers = forced_runs["cfg"], forced_runs["tiers"]
    assert tiers["rmsnorm"] == {"ref": 2 * cfg.n_layers + 1 + N_STEPS}
    assert tiers["attn_block"] == {"ref": cfg.n_layers * N_STEPS}
