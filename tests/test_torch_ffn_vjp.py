"""The fused FFN's backward (ops/ffn.FusedFFN, JAX's `_ffn_diff_bwd`) against
jax.grad of the JAX package's `fused_ffn_pallas`, on the CPU.

The JAX side runs its Pallas kernels in interpret mode: K6b / K6a's no-norm
form forward, and in the backward the recompute of gate|up through
qmatmul_pallas at the tier of its rows (K1 under ZGML_TPU_I8DOT at <= 32
rows) and K11 twice. The port runs its plain versions (CPU tensors) through
the same function: the gradient is that of comp(h) = qmatmul(swiglu(
qmatmul(h, gu)), wd) with the recompute's own gate|up, not of the fused
forward's f32 act. Weights are layer 0 of a synthetic GGUF at d 512 (where
both kinds fuse) read by both packages. Flags are set around both packages.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zgml_tpu.io.llama_loader import load_llama as jax_load_llama
from zgml_tpu.nn import losses as jlosses
from zgml_tpu.ops import dispatch as jdispatch
from zgml_tpu.ops.ffn import fused_ffn_pallas

from zgml_tpu_torch.io.gguf import GGMLType
from zgml_tpu_torch.io.llama_loader import load_llama
from zgml_tpu_torch.models import llama as tllama
from zgml_tpu_torch.models.llama import LlamaConfig, LlamaModel
from zgml_tpu_torch.nn import losses
from zgml_tpu_torch.nn.train import value_and_grad
from zgml_tpu_torch.ops import dispatch
from zgml_tpu_torch.runtime.profile import global_profile
from zgml_tpu_torch.utils.synthetic import write_synthetic_llama_gguf
from zgml_tpu_torch.utils.tree import flatten

jqmm = importlib.import_module("zgml_tpu.ops.qmatmul")   # ops.qmatmul is also a function

torch.set_num_threads(1)

CFG = LlamaConfig(vocab_size=96, d_model=512, n_heads=8, n_kv_heads=2, d_ff=1024, n_layers=2,
                  max_seq_len=96)
FLAGS = {"ZGML_TPU_PREFILL_BF16": "0", "ZGML_TPU_SCALES": "f16"}
DX_RTOL = 1e-5            # dx vs JAX: f32 sums in another order, the same int8 activations
GRAD_RTOL = 1e-3          # the model's gradients (floor; see _check_grads)
ROWS = (1, 8, 31, 32)


@pytest.fixture(autouse=True)
def _flags(monkeypatch):
    for k, v in FLAGS.items():
        monkeypatch.setenv(k, v)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("ffn_vjp")
    out = {}
    with pytest.MonkeyPatch.context() as mp:       # the loaders read the flags too
        for k, v in FLAGS.items():
            mp.setenv(k, v)
        for kind, seed in (("q4_0", 31), ("q8_0", 32)):
            out[kind] = _load(d, kind, seed)
    return out


def _load(d, kind, seed):
    path = str(d / f"{kind}.gguf")
    write_synthetic_llama_gguf(path, CFG, quant=GGMLType[kind.upper()], seed=seed)
    jm, jf = jax_load_llama(path)
    jf.close()
    tm, tf = load_llama(path, device="cpu")
    tf.close()
    return jm, tm


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _jax_tier(m: int) -> tuple[bool, bool]:
    """(int8, bf16) that JAX's qmatmul_pallas / _qmm_diff take for m rows
    (qmatmul.py:636-648, 719-737)."""
    m_pad = max(8, jqmm._round_up(m, 8))
    bm = m_pad if m_pad <= 512 else jqmm._choose_tile(m_pad, 256, mult=8)
    i8 = jqmm._i8dot_enabled() and bm == m_pad and bm <= 32
    from zgml_tpu import config as jconfig
    return i8, (not i8) and bm >= 32 and jconfig.prefill_bf16()


@pytest.mark.parametrize("i8dot", ["0", "1"])
@pytest.mark.parametrize("prefill_bf16", ["0", "1"])
def test_projection_tier_rule_matches_jax(monkeypatch, i8dot, prefill_bf16):
    """The port's tier of a projection (dispatch._tier) is JAX's at 1, 8, 31,
    32 and 33 rows (JAX pads the rows to a multiple of 8 first)."""
    monkeypatch.setenv("ZGML_TPU_I8DOT", i8dot)
    monkeypatch.setenv("ZGML_TPU_PREFILL_BF16", prefill_bf16)
    for m in (1, 8, 31, 32, 33, 40, 64):
        assert dispatch._tier(m) == _jax_tier(m), m


@pytest.mark.parametrize("i8dot", ["0", "1"])
@pytest.mark.parametrize("kind", ["q4_0", "q8_0"])
@pytest.mark.parametrize("m", ROWS)
def test_fused_ffn_dx_matches_jax(models, monkeypatch, kind, m, i8dot):
    """dh of the fused FFN at m rows (h normed, a random cotangent) against
    jax.grad of fused_ffn_pallas, within DX_RTOL * max|dh|; the forward
    within the same; the placement: the fused FFN once (K6b / K6a no-norm),
    the recompute's gate|up at JAX's tier and K11 twice, each counted."""
    monkeypatch.setenv("ZGML_TPU_I8DOT", i8dot)
    jm, tm = models[kind]
    jl, tl = jm.params["layers"][0], tm.params["layers"][0]
    rng = np.random.default_rng(m + 100 * (kind == "q8_0"))
    h = rng.standard_normal((m, CFG.d_model)).astype(np.float32)
    g = rng.standard_normal((m, CFG.d_model)).astype(np.float32)
    jy, jvjp = jax.vjp(lambda x: fused_ffn_pallas(x, jl["w_gate_up"], jl["w_down"]),
                       jnp.asarray(h))
    (jdx,) = jvjp(jnp.asarray(g))
    ht = torch.from_numpy(h).requires_grad_()
    global_profile.reset()
    y = dispatch.fused_ffn(ht, tl["w_gate_up"], tl["w_down"])
    (dx,) = torch.autograd.grad(y, ht, torch.from_numpy(g))
    tiers = global_profile.tier_summary()
    sfx = "" if kind == "q4_0" else "_q8"
    i8, bf16 = dispatch._tier(m)
    proj = "qmatmul_i8" if i8 else "qmatmul_bf16" if bf16 else "qmatmul"
    assert tiers[f"fused_ffn{sfx}"] == {"ref": 1}, tiers
    assert tiers[proj + sfx] == {"ref": 1}, tiers
    assert tiers[f"qmatmul_bwd{sfx}"] == {"ref": 2}, tiers
    assert _rel(y.detach().numpy(), np.asarray(jy)) <= DX_RTOL
    err = _rel(dx.numpy(), np.asarray(jdx))
    assert err <= DX_RTOL, (kind, m, i8dot, err)


def test_33_rows_take_the_composed_path(models):
    """At 33 rows JAX's dispatch does not fuse (fused_ffn returns None), and
    the port's FFN half-layer under autograd places no fused FFN: two
    projections and their K11."""
    jm, tm = models["q4_0"]
    jl, tl = jm.params["layers"][0], tm.params["layers"][0]
    x = np.random.default_rng(3).standard_normal((1, 33, CFG.d_model)).astype(np.float32)
    assert jdispatch.fused_ffn(jnp.asarray(x), jl["w_gate_up"], jl["w_down"]) is None
    xt = torch.from_numpy(x).requires_grad_()
    global_profile.reset()
    y = tllama._ffn(CFG, xt, tl, after_attn_block=False)
    torch.autograd.grad(y.sum(), xt)
    tiers = global_profile.tier_summary()
    assert "fused_ffn" not in tiers and tiers["qmatmul_bwd"] == {"ref": 2}, tiers
    xs = xt.detach()[:, :32].requires_grad_()
    global_profile.reset()
    tllama._ffn(CFG, xs, tl, after_attn_block=False)
    assert global_profile.tier_summary()["fused_ffn"] == {"ref": 1}


def test_normed_form_still_refuses_grad(models):
    """K6a / K6c / K6d's normed form has no VJP in JAX
    (`fused_ffn_norm_pallas` is inference-only): under autograd it raises."""
    _, tm = models["q8_0"]
    tl = tm.params["layers"][0]
    x = torch.zeros((1, 4, CFG.d_model), requires_grad=True)
    with pytest.raises(NotImplementedError, match="K6a / K6c / K6d.*ROADMAP"):
        dispatch.fused_ffn_norm(x, tl["ffn_norm"], tl["w_gate_up"], tl["w_down"], 1e-5)


# -- a 2-layer frozen model at B 1 x T 16 ---------------------------------------

def _trainable(params):
    return {"tok_embd": params["tok_embd"], "out_norm": params["out_norm"],
            "layers": [{"attn_norm": ly["attn_norm"], "ffn_norm": ly["ffn_norm"]}
                       for ly in params["layers"]]}


def _merge(full, tr):
    return {**full, "tok_embd": tr["tok_embd"], "out_norm": tr["out_norm"],
            "layers": [{**ly, **t} for ly, t in zip(full["layers"], tr["layers"])]}


def _port_loss(full):
    def loss(tr, x, y):
        logits = LlamaModel(CFG, _merge(full, tr))(x)
        return losses.cross_entropy_idx(logits[:, :-1], y[:, 1:])
    return loss


def _moves(loss_fn, params, tokens, draws=3):
    """How far the port's own loss and gradients move (|dl| / |l|, max|dg| /
    max|g| per tensor) when tok_embd is scaled by (1 + 1e-7 N(0, 1)): K and
    V round to bf16 and the activations to int8 (K1), so f32 noise of that
    size flips roundings."""
    l0, g0 = value_and_grad(loss_fn, params, tokens, tokens)
    gen = torch.Generator().manual_seed(0)
    leaves0, _ = flatten(g0)
    moved, loss_moved = [0.0] * len(leaves0), 0.0
    for _ in range(draws):
        emb = params["tok_embd"]
        p2 = {**params, "tok_embd": emb * (1 + 1e-7 * torch.randn(emb.shape, generator=gen))}
        l1, g1 = value_and_grad(loss_fn, p2, tokens, tokens)
        moved = [max(mv, _rel(a, b)) for mv, a, b in zip(moved, flatten(g1)[0], leaves0)]
        loss_moved = max(loss_moved, abs(float(l1) - float(l0)) / abs(float(l0)))
    return loss_moved, moved


@pytest.mark.parametrize("i8dot", ["0", "1"])
@pytest.mark.parametrize("kind", ["q4_0", "q8_0"])
def test_short_sequence_frozen_grads_match_jax(models, monkeypatch, kind, i8dot):
    """LlamaModel.forward of the frozen model at B 1 x T 16 (16 rows: the
    fused FFN, K1 or K2 projections) no longer raises under autograd; the
    gradients of tok_embd and the norms against jax.grad, each tensor within
    max(GRAD_RTOL, 2 x the port's own move under 1e-7 embedding
    perturbations) of its max|g|; the loss within max(1e-5, 2 x the port's
    own move) (Q8_0: 1.2e-5 and 1.7e-4 from JAX at I8DOT 0 and 1)."""
    monkeypatch.setenv("ZGML_TPU_I8DOT", i8dot)
    jm, tm = models[kind]
    tokens = np.random.default_rng(9).integers(0, CFG.vocab_size, (1, 16)).astype(np.int32)
    jfull = jm.params

    def jloss(tr):
        params = _merge(jfull, tr)
        logits, _ = jm.forward(params, jnp.asarray(tokens), jm.init_cache(1, layout="unrolled"),
                               0)
        return jlosses.cross_entropy_idx(logits[:, :-1], jnp.asarray(tokens)[:, 1:])

    jl, jg = jax.value_and_grad(jloss)(_trainable(jfull))
    tt = torch.from_numpy(tokens)
    full = tm.params
    global_profile.reset()
    tl, tg = value_and_grad(_port_loss(full), _trainable(full), tt, tt)
    tiers = global_profile.tier_summary()
    sfx = "" if kind == "q4_0" else "_q8"
    assert tiers[f"fused_ffn{sfx}"] == {"ref": CFG.n_layers}, tiers
    assert f"fused_ffn_norm{sfx}" not in tiers
    assert tiers[f"qmatmul_bwd{sfx}"] == {"ref": CFG.n_layers * 4 + 1}, tiers
    loss_move, moves = _moves(_port_loss(full), _trainable(full), tt)
    loss_err = abs(float(tl) - float(jl)) / abs(float(jl))
    assert loss_err <= max(1e-5, 2 * loss_move), (loss_err, loss_move)
    want = flatten(jax.tree.map(np.asarray, jg))[0]
    errs = [_rel(a, b) for a, b in zip(flatten(tg)[0], want)]
    bounds = [max(GRAD_RTOL, 2 * mv) for mv in moves]
    assert all(e <= b for e, b in zip(errs, bounds)), list(zip(errs, bounds))
    print(f"{kind} I8DOT={i8dot}: loss {loss_err:.3g} (own move {loss_move:.3g}); gradients "
          f"worst err / bound {max(e / b for e, b in zip(errs, bounds)):.3g}")


# -- force_ref() and a backward on another thread ---------------------------------

@pytest.mark.parametrize("path", ["qmatmul", "fused_ffn"])
def test_backward_keeps_the_forwards_tier_on_another_thread(models, monkeypatch, path):
    """Autograd runs a CUDA backward on its own device thread, where
    force_ref()'s context variable is not set: the backward's kernels are
    decided at forward time. Forward under force_ref() with the card faked
    (the kernels' stand-ins count `cuda`), backward on a fresh thread: every
    backward call is the plain version. Before this, K11 and K1's recompute
    ran on the card inside force_ref()'s gradients (the smoke's dx was
    bit-equal to itself)."""
    import threading
    from zgml_tpu_torch.ops import ffn, qmatmul as qmm
    monkeypatch.setenv("ZGML_TPU_I8DOT", "1")
    real = dispatch._device_of

    def on_card(*t):
        real(*t)
        return torch.device("cuda")

    def stand_in(name, plain):
        def call(*a):
            global_profile.count_op(qmm.counter(name, a[-1].kind if name != "fused_ffn"
                                                else a[1].kind), "cuda")
            return plain(*a)
        return call
    monkeypatch.setattr(dispatch, "_device_of", on_card)
    monkeypatch.setattr(qmm, "qmatmul_bwd_cuda", stand_in("qmatmul_bwd", qmm.qmatmul_bwd_ref))
    monkeypatch.setattr(qmm, "qmatmul_i8_cuda", stand_in("qmatmul_i8", qmm.qmatmul_i8_ref))
    monkeypatch.setattr(ffn, "fused_ffn_cuda", stand_in("fused_ffn", ffn.fused_ffn_ref))
    _, tm = models["q4_0"]
    tl = tm.params["layers"][0]
    x = torch.randn((1, 4, CFG.d_model), generator=torch.Generator().manual_seed(0))
    leaf = x.requires_grad_()
    global_profile.reset()
    with dispatch.force_ref():
        y = (dispatch.qmatmul(leaf, tl["wqkv"]) if path == "qmatmul"
             else dispatch.fused_ffn(leaf, tl["w_gate_up"], tl["w_down"]))
    t = threading.Thread(target=lambda: y.sum().backward())
    t.start()
    t.join()
    tiers = global_profile.tier_summary()
    assert leaf.grad is not None
    assert all(set(v) == {"ref"} for k, v in tiers.items() if k != "rmsnorm"), tiers
    assert tiers["qmatmul_bwd"] == {"ref": 1 if path == "qmatmul" else 2}, tiers
