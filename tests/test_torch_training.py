"""The port's training slice against the JAX package, on the CPU: losses,
optimizers, the batch loader, checkpoints, one llama training step's
gradients and a short train_supervised run.

The JAX side runs its Pallas kernels in interpret mode (flash attention with
its custom VJP, the quantized matmul with its K11 backward) at
ZGML_TPU_PREFILL_BF16=0 and ZGML_TPU_SCALES=f16, set around both packages;
the port runs its plain versions (CPU tensors). Both take the same numpy
inputs. Bounds are stated at each test with what they allow for.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zgml_tpu.data import DataLoader as JaxDataLoader
from zgml_tpu.io.checkpoint import load_checkpoint as jax_load_ckpt
from zgml_tpu.io.checkpoint import save_checkpoint as jax_save_ckpt
from zgml_tpu.io.llama_loader import load_llama as jax_load_llama
from zgml_tpu.models import llama as jllama
from zgml_tpu.nn import losses as jlosses
from zgml_tpu.nn.train import train_supervised as jax_train_supervised
from zgml_tpu.optim import adam as jadam
from zgml_tpu.optim import sgd as jsgd

from zgml_tpu_torch.data.dataloader import DataLoader
from zgml_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from zgml_tpu_torch.io.gguf import GGMLType
from zgml_tpu_torch.io.llama_loader import load_llama, params_from_jax
from zgml_tpu_torch.models.llama import LlamaConfig, LlamaModel, init_params
from zgml_tpu_torch.nn import losses
from zgml_tpu_torch.nn.train import train_supervised, value_and_grad
from zgml_tpu_torch.optim import adam, sgd
from zgml_tpu_torch.runtime.profile import global_profile
from zgml_tpu_torch.utils.synthetic import write_synthetic_llama_gguf
from zgml_tpu_torch.utils.tree import flatten

torch.set_num_threads(1)

FLAGS = {"ZGML_TPU_PREFILL_BF16": "0", "ZGML_TPU_SCALES": "f16"}
DENSE_CFG = LlamaConfig(vocab_size=96, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
                        n_layers=2, max_seq_len=64)
QUANT_CFG = LlamaConfig(vocab_size=96, d_model=512, n_heads=8, n_kv_heads=2, d_ff=1024,
                        n_layers=2, max_seq_len=96)       # tests/test_torch_llama.py DEFAULT_CFG
E2E_CFG = LlamaConfig(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, n_layers=2,
                      max_seq_len=16, tied_lm_head=True)  # tests/test_training.py:149-150


@pytest.fixture(autouse=True)
def _flags(monkeypatch):
    for k, v in FLAGS.items():
        monkeypatch.setenv(k, v)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


# -- losses and optimizers ----------------------------------------------------

def test_losses_match_jax():
    """mean_sq_err, cross_entropy and cross_entropy_idx within 1e-6."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((4, 7, 33)).astype(np.float32) * 3
    probs = rng.dirichlet(np.ones(33), (4, 7)).astype(np.float32)
    idx = rng.integers(0, 33, (4, 7))
    pred, target = logits[..., :5], probs[..., :5]
    for got, want in ((losses.mean_sq_err(_t(pred), _t(target)),
                       jlosses.mean_sq_err(jnp.asarray(pred), jnp.asarray(target))),
                      (losses.cross_entropy(_t(logits), _t(probs)),
                       jlosses.cross_entropy(jnp.asarray(logits), jnp.asarray(probs))),
                      (losses.cross_entropy_idx(_t(logits), torch.from_numpy(idx)),
                       jlosses.cross_entropy_idx(jnp.asarray(logits), jnp.asarray(idx)))):
        assert abs(float(got) - float(want)) <= 1e-6 * max(1.0, abs(float(want)))


def _quadratic_grads(rng, p):
    return jax.tree.map(lambda v: rng.standard_normal(v.shape).astype(np.float32) + 0.1 * v, p)


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam", "adamw"])
def test_optimizers_match_jax_over_20_steps(opt):
    """The same 20 gradients into both packages' update: params (and the
    optimizer state) within 1e-6 after every step."""
    rng = np.random.default_rng(1)
    p0 = {"w": rng.standard_normal((8, 5)).astype(np.float32), "b": np.zeros(5, np.float32),
          "nest": {"s": rng.standard_normal(3).astype(np.float32)}}
    jp = jax.tree.map(jnp.asarray, p0)
    tp = jax.tree.map(_t, p0)
    cfg_kw = dict(lr=0.05, weight_decay=0.01 if opt == "adamw" else 0.0)
    jst = (jadam.adam_init(jp) if opt.startswith("adam")
           else jsgd.sgd_init(jp) if opt == "momentum" else None)
    tst = (adam.adam_init(tp) if opt.startswith("adam")
           else sgd.sgd_init(tp) if opt == "momentum" else None)
    for _ in range(20):
        g = _quadratic_grads(rng, jax.tree.map(np.asarray, jp))
        jg, tg = jax.tree.map(jnp.asarray, g), jax.tree.map(_t, g)
        if opt == "sgd":
            jp, tp = jsgd.sgd_update(jp, jg, 0.05), sgd.sgd_update(tp, tg, 0.05)
        elif opt == "momentum":
            jp, jst = jsgd.sgd_momentum_update(jp, jg, jst, 0.05)
            tp, tst = sgd.sgd_momentum_update(tp, tg, tst, 0.05)
        else:
            jp, jst = jadam.adam_update(jp, jg, jst, jadam.AdamConfig(**cfg_kw))
            tp, tst = adam.adam_update(tp, tg, tst, adam.AdamConfig(**cfg_kw))
        for path in (("w",), ("b",), ("nest", "s")):
            a, b = jp, tp
            for k in path:
                a, b = a[k], b[k]
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-6)
    if opt.startswith("adam"):
        assert int(tst["t"]) == int(jst["t"]) == 20
        np.testing.assert_allclose(tst["v"]["w"].numpy(), np.asarray(jst["v"]["w"]),
                                   rtol=1e-6, atol=1e-9)


def test_dataloader_batches_equal_jax():
    x, y = np.arange(100), np.arange(100) * 2
    ours, theirs = DataLoader(x, y, batch_size=16, seed=3), JaxDataLoader(x, y, batch_size=16,
                                                                          seed=3)
    assert len(ours) == len(theirs) == 6
    for _ in range(2):          # two epochs: the generator state carries over alike
        for (a, b), (c, d) in zip(ours, theirs, strict=True):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)


# -- checkpoints ----------------------------------------------------------------

def test_checkpoints_cross_read(tmp_path):
    """A JAX-written ZGMT file loads in the port and the other way round,
    params and Adam state, bit for bit, with the JAX package's names."""
    rng = np.random.default_rng(4)
    tree = {"params": {"a": rng.standard_normal((2, 3)).astype(np.float32),
                       "layers": [{"w": rng.standard_normal(4).astype(np.float32)}]},
            "n": np.arange(5, dtype=np.int32)}
    jtree = jax.tree.map(jnp.asarray, tree)
    jtree["opt"] = jadam.adam_init(jtree["params"])
    ttree = jax.tree.map(torch.from_numpy, tree)
    ttree["opt"] = adam.adam_init(ttree["params"])
    jax_save_ckpt(tmp_path / "j.zgmt", jtree)
    got = load_checkpoint(tmp_path / "j.zgmt", ttree)
    save_checkpoint(tmp_path / "t.zgmt", got)
    back = jax_load_ckpt(tmp_path / "t.zgmt", jtree)
    for a, b, c in zip(jax.tree.leaves(jtree), jax.tree.leaves(
            jax.tree.map(lambda t: t.numpy(), got)), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(c))
    assert (tmp_path / "j.zgmt").read_bytes() == (tmp_path / "t.zgmt").read_bytes()
    with pytest.raises(ValueError, match="shape mismatch"):
        load_checkpoint(tmp_path / "j.zgmt", {**ttree, "n": torch.zeros(4, dtype=torch.int32)})


# -- one llama training step -----------------------------------------------------

def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def test_init_params_match_jax():
    """init_params draws the JAX package's values from one seed; the dense
    stacked tree converts to the same per-layer list."""
    jp = jllama.init_params(DENSE_CFG, seed=5)
    tp = init_params(DENSE_CFG, seed=5, device="cpu")
    conv = params_from_jax(_np_tree(jp), DENSE_CFG, device="cpu")
    for li in range(DENSE_CFG.n_layers):
        for name, stacked in jp["layers"].items():
            np.testing.assert_array_equal(tp["layers"][li][name].numpy(), np.asarray(stacked[li]))
            np.testing.assert_array_equal(conv["layers"][li][name].numpy(),
                                          np.asarray(stacked[li]))
    for name in ("tok_embd", "out_norm", "lm_head"):
        np.testing.assert_array_equal(tp[name].numpy(), np.asarray(jp[name]))


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
    """How far the port's own gradients move (max|dg| / max|g| per tensor)
    when tok_embd is scaled by (1 + 1e-7 N(0, 1)): K and V are rounded to
    bf16, so f32 noise of that size flips some of their roundings, and a
    flip moves the gradients far more than f32 noise does (measured: 1.6e-3
    at attn_norm, dense; 2.5e-3, Q4_0)."""
    _, g0 = value_and_grad(loss_fn, params, tokens, tokens)
    gen = torch.Generator().manual_seed(0)
    leaves0, _ = flatten(g0)
    moved = [0.0] * len(leaves0)
    for _ in range(draws):
        emb = params["tok_embd"]
        p2 = {**params, "tok_embd": emb * (1 + 1e-7 * torch.randn(emb.shape, generator=gen))}
        leaves1, _ = flatten(value_and_grad(loss_fn, p2, tokens, tokens)[1])
        moved = [max(m, _rel(a, b)) for m, a, b in zip(moved, leaves1, leaves0)]
    return moved


def _check_grads(got, want_leaves, moves, what):
    """Each tensor within max(1e-4, 2 x the port's own move) of JAX's,
    relative to its max|grad| (the smoke's rule on the card)."""
    errs = [_rel(g, w) for g, w in zip(flatten(got)[0], want_leaves)]
    bounds = [max(1e-4, 2 * m) for m in moves]
    print(f"{what}: max rel err {max(errs):.3g}, worst err / bound "
          f"{max(e / b for e, b in zip(errs, bounds)):.3g}")
    assert all(e <= b for e, b in zip(errs, bounds)), list(zip(errs, bounds))


def test_dense_llama_step_grads_match_jax():
    """One step's gradients of every leaf of a dense 2-layer GQA llama (d 128,
    hd 32, B 2 x T 32) against jax.grad through the Pallas flash VJP (_moves,
    _check_grads: measured up to 1.5e-3, at 0.26 of its tensor's bound); the
    loss within 1e-6."""
    jp = jllama.init_params(DENSE_CFG, seed=6, scale=0.1)
    tokens = np.random.default_rng(7).integers(0, DENSE_CFG.vocab_size, (2, 32)).astype(np.int32)
    jmodel = jllama.LlamaModel(DENSE_CFG, jp)
    jl, jg = jax.value_and_grad(_jax_loss(jmodel))(jp, jnp.asarray(tokens), jnp.asarray(tokens))
    tp = params_from_jax(_np_tree(jp), DENSE_CFG, device="cpu")
    tt = torch.from_numpy(tokens)
    global_profile.reset()
    tl, tg = value_and_grad(_port_loss(DENSE_CFG), tp, tt, tt)
    tiers = global_profile.tier_summary()
    assert tiers["flash_fwd"] == tiers["flash_dq"] == tiers["flash_dkv"] == {"ref": 2}, tiers
    assert tiers["matmul"] == {"torch": 2 * 7 + 1}, tiers
    assert abs(float(tl) - float(jl)) <= 1e-6 * abs(float(jl))
    jg = _np_tree(jg)
    want = params_from_jax(jg, DENSE_CFG, device="cpu")      # the same tree as the port's
    _check_grads(tg, flatten(want)[0], _moves(_port_loss(DENSE_CFG), tp, tt), "dense")


@pytest.fixture(scope="module")
def quant_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_q")
    out = {}
    for kind, seed in (("q4_0", 21), ("q8_0", 22)):
        out[kind] = str(d / f"{kind}.gguf")
        write_synthetic_llama_gguf(out[kind], QUANT_CFG, quant=GGMLType[kind.upper()], seed=seed)
    return out


def _trainable(params):
    return {"tok_embd": params["tok_embd"], "out_norm": params["out_norm"],
            "layers": [{"attn_norm": ly["attn_norm"], "ffn_norm": ly["ffn_norm"]}
                       for ly in params["layers"]]}


def _merge(full, tr):
    return {**full, "tok_embd": tr["tok_embd"], "out_norm": tr["out_norm"],
            "layers": [{**ly, **t} for ly, t in zip(full["layers"], tr["layers"])]}


@pytest.mark.parametrize("kind", ["q4_0", "q8_0"])
def test_frozen_quantized_step_grads_match_jax(quant_paths, monkeypatch, kind):
    """The quantized d 512 model of tests/test_torch_llama.py, its Q4_0 or
    Q8_0 projections frozen, B 2 x T 24 (48 rows: K2 forward, K11 backward
    on both sides): the gradients of tok_embd and the norms against jax.grad
    (_check_grads; measured up to 2.3e-3 at Q4_0 and 3.4e-3 at Q8_0, at 0.68
    and 0.59 of their tensors' bounds)."""
    with monkeypatch.context() as mp:
        mp.delenv("ZGML_TPU_I8DOT", raising=False)
        jmodel, jgf = jax_load_llama(quant_paths[kind])
        jgf.close()
        tmodel, tgf = load_llama(quant_paths[kind], device="cpu")
        tgf.close()
        tokens = np.random.default_rng(8).integers(0, QUANT_CFG.vocab_size, (2, 24))
        tokens = tokens.astype(np.int32)
        jfull = jmodel.params
        # the per-layer cache: JAX's default stacked one would read layer li
        # through kv_row = li, which its flash backward does not take
        jloss = _jax_loss(jmodel, layout="unrolled")
        jl, jg = jax.value_and_grad(lambda tr: jloss(_merge(jfull, tr), jnp.asarray(tokens),
                                                     jnp.asarray(tokens)))(_trainable(jfull))
        tt = torch.from_numpy(tokens)
        full = tmodel.params
        global_profile.reset()
        tl, tg = value_and_grad(lambda tr, x, y: _port_loss(QUANT_CFG)(_merge(full, tr), x, y),
                                _trainable(full), tt, tt)
        tiers = global_profile.tier_summary()
    sfx = "" if kind == "q4_0" else "_q8"
    n_proj = QUANT_CFG.n_layers * 4 + 1
    assert tiers[f"qmatmul{sfx}"] == tiers[f"qmatmul_bwd{sfx}"] == {"ref": n_proj}, tiers
    assert tiers["flash_dkv"] == {"ref": QUANT_CFG.n_layers}
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    with monkeypatch.context() as mp:
        mp.delenv("ZGML_TPU_I8DOT", raising=False)
        moves = _moves(lambda tr, x, y: _port_loss(QUANT_CFG)(_merge(full, tr), x, y),
                       _trainable(full), tt)
    _check_grads(tg, flatten(_np_tree(jg))[0], moves, kind)


def test_grad_through_a_kernel_without_backward_raises(quant_paths):
    """K6's normed form (K6d here), which has no backward in JAX either,
    raises under autograd instead of returning a zero gradient. A call of
    <= 32 rows now reaches the fused FFN K6b through ops/ffn.FusedFFN, which
    has one: the model's forward at 16 rows gives a gradient."""
    from zgml_tpu_torch.ops import dispatch
    tmodel, tgf = load_llama(quant_paths["q4_0"], device="cpu")
    tgf.close()
    ly = tmodel.params["layers"][0]
    x = torch.zeros((1, 1, QUANT_CFG.d_model), requires_grad=True)
    with pytest.raises(NotImplementedError, match="K6d.*ROADMAP"):
        dispatch.fused_ffn_norm(x, ly["ffn_norm"], ly["w_gate_up"], ly["w_down"], 1e-5)
    tokens = torch.zeros((1, 16), dtype=torch.int64)
    tr = {"tok_embd": tmodel.params["tok_embd"].clone().requires_grad_()}
    out = LlamaModel(QUANT_CFG, {**tmodel.params, **tr})(tokens)
    (g,) = torch.autograd.grad(out.sum(), tr["tok_embd"])
    assert out.shape == (1, 16, 96) and bool(torch.isfinite(g).all()) and bool(g.abs().sum() > 0)


# -- train_supervised -------------------------------------------------------------

def test_train_supervised_matches_jax_trajectory():
    """tests/test_training.py's llama end-to-end config (hd 8, the plain
    path): 30 epochs of 4 batches from the same permutations; every epoch's
    mean loss within 1e-3 of JAX's, and the trained port model predicts 7
    after [3, 4, 5, 6]."""
    rng = np.random.default_rng(0)
    seqs = np.stack([np.arange(i, i + 9) % 16 for i in rng.integers(0, 16, 64)]).astype(np.int32)
    jp = jllama.init_params(E2E_CFG, seed=0)
    jmodel = jllama.LlamaModel(E2E_CFG, jp)
    _, jlosses_ = jax_train_supervised(jp, _jax_loss(jmodel), seqs, seqs, epochs=30,
                                       batch_size=16, adam=jadam.AdamConfig(lr=5e-3))
    tp = init_params(E2E_CFG, seed=0, device="cpu")
    tp, tlosses = train_supervised(tp, _port_loss(E2E_CFG), seqs.astype(np.int64), seqs,
                                   epochs=30, batch_size=16, adam=adam.AdamConfig(lr=5e-3))
    diff = np.max(np.abs(np.asarray(tlosses) - np.asarray(jlosses_)))
    print(f"per-epoch losses: max |port - jax| {diff:.3g}; first {tlosses[0]:.4f} last "
          f"{tlosses[-1]:.4f}")
    assert diff <= 1e-3
    assert tlosses[-1] < tlosses[0] * 0.3
    with torch.no_grad():
        logits = LlamaModel(E2E_CFG, tp)(torch.tensor([[3, 4, 5, 6]]))
    assert int(torch.argmax(logits[0, -1])) == 7
