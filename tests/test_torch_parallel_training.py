"""The training half of zgml_tpu_torch.parallel on the CPU against the JAX
package's: make_sharded_train_step (tp.py:510-546) and the GPipe pipeline
(pp.py), forward and train step.

The port's ranks are a gloo world of 4 CPU processes (parallel/world.World),
spawned once for the module, running the functions of
tests/torch_parallel_tasks.py; the JAX side runs as tests/test_sharding.py
runs it, on the conftest's 8 virtual CPU devices (Pallas kernels in interpret
mode). Dense weights from JAX's init_params go to both. Both packages read
the JAX flags, set around both sides: ZGML_TPU_PREFILL_BF16=0 (the f32
function, where the two differ only in the order of f32 sums) and
ZGML_TPU_SCALES=f16.

Bounds: the loss within 1e-4 of JAX's and the parameters after the steps at
rtol 1e-4 / atol 1e-5 (the sharded train step) or rtol 1e-3 / atol 1e-4
(the pipelined one), JAX's own bounds (tests/test_sharding.py:112-123,
350-364); every gradient within 1e-4 of max|g| of the port's one-process
gradient on the same batch (f32 sums in another order, and the dp mean);
the pipeline's logits and cache within 1e-5 of max (the f32 function);
replicated leaves bit-identical on every rank.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_tasks as tasks
from zgml_tpu.models.llama import LlamaConfig as JCfg, LlamaModel as JModel
from zgml_tpu.models.llama import init_params as jax_init_params
from zgml_tpu.parallel import make_mesh as jax_make_mesh
from zgml_tpu.parallel import make_sharded_train_step as jax_train_step
from zgml_tpu.parallel import shard_llama_params as jax_shard_params
from zgml_tpu.parallel.pp import _choose_micro as jax_choose_micro
from zgml_tpu.parallel.pp import make_pp_forward as jax_pp_forward
from zgml_tpu.parallel.pp import make_pp_train_step as jax_pp_step
from zgml_tpu.parallel.pp import shard_pp_params as jax_shard_pp

from zgml_tpu_torch.io.llama_loader import params_from_jax
from zgml_tpu_torch.models.llama import LlamaConfig, LlamaModel
from zgml_tpu_torch.parallel.pp import _choose_micro
from zgml_tpu_torch.parallel.tp import next_token_nll
from zgml_tpu_torch.parallel.world import World
from zgml_tpu_torch.utils.tree import paths

torch.set_num_threads(2)

WORLD_TIMEOUT = 120
F32 = {"ZGML_TPU_SCALES": "f16", "ZGML_TPU_PREFILL_BF16": "0"}
TP_CFG = JCfg(vocab_size=256, d_model=64, n_heads=8, n_kv_heads=4, d_ff=128, n_layers=2,
              max_seq_len=32)
PP_CFG = JCfg(vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, n_layers=4,
              max_seq_len=32, tied_lm_head=True)
COL = ("wq", "wk", "wv", "w_gate", "w_up")
ROW = ("wo", "w_down")


@pytest.fixture(scope="module")
def world():
    with World(4, backend="gloo", device="cpu") as w:
        yield w


@pytest.fixture(scope="module")
def world2():
    with World(2, backend="gloo", device="cpu") as w:
        yield w


def _env(mp, flags):
    for k, v in flags.items():
        mp.setenv(k, v)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _src(jcfg, jparams):
    return ("jax", LlamaConfig(**dataclasses.asdict(jcfg)), _np(jparams))


def _close(got, want, rtol, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max_abs_err {err:.3g} > {rtol:g} x max|want| {scale:.3g}"


def _jax_leaf(jp, path):
    """JAX's stacked params at a port path: layers/<li>/<name> -> [li]."""
    parts = path.split("/")
    if parts[0] == "layers":
        return np.asarray(jp["layers"][parts[2]][int(parts[1])])
    return np.asarray(jp[parts[0]])


def _one_process_grads(jcfg, jparams, tokens):
    """The port's one-process loss and gradients by path on the full batch."""
    cfg = LlamaConfig(**dataclasses.asdict(jcfg))
    model = LlamaModel(cfg, params_from_jax(_np(jparams), cfg, device="cpu"))
    named = paths(model.params)
    for _, t in named:
        t.requires_grad_(True)
    loss = next_token_nll(model(torch.as_tensor(tokens)[:, :-1]), torch.as_tensor(tokens))
    grads = torch.autograd.grad(loss, [t for _, t in named])
    return float(loss.detach()), {p: g.numpy() for (p, _), g in zip(named, grads)}


def _tp_full(res, path, tp):
    """A leaf of the full model from the tp shards of dp group 0 (rank order
    i_dp * tp + i_tp): concatenated where it is sharded, else tp rank 0's."""
    name = path.split("/")[-1]
    shards = [res[i][path] for i in range(tp)]
    if name in COL or name == "lm_head":
        return np.concatenate(shards, axis=1)
    if name in ROW:
        return np.concatenate(shards, axis=0)
    return shards[0]


def _replicated(path):
    name = path.split("/")[-1]
    return name not in COL + ROW + ("lm_head",)


@pytest.mark.parametrize("tp,dp", [(2, 1), (2, 2), (4, 1)])
def test_sharded_train_step_matches_jax(request, monkeypatch, tp, dp):
    """Two steps of make_sharded_train_step at lr 0.1 on [4, 9] tokens against
    JAX's two steps (loss, params), the first step's gradients against the
    port's one-process gradients, the replicated leaves the same bits on
    every rank, the tp ranks' flash attention counted on their local heads."""
    _env(monkeypatch, F32)
    jparams = jax_init_params(TP_CFG, seed=0)
    tokens = np.random.default_rng(2).integers(0, 256, (4, 9))
    mesh = jax_make_mesh(tp=tp, dp=dp, devices=jax.devices()[:tp * dp])
    jmodel = JModel(TP_CFG, jparams)
    step = jax_train_step(jmodel, mesh)
    new, losses = jax_shard_params(jparams, mesh), []
    for _ in range(2):
        loss, new = step(new, jnp.asarray(tokens, jnp.int32), jmodel.init_cache(4), 0.1)
        losses.append(float(loss))
    world = request.getfixturevalue("world" if tp * dp == 4 else "world2")
    res = world.run(tasks.tp_train, _src(TP_CFG, jparams), tp, dp, tokens, 0.1, 2,
                    timeout=WORLD_TIMEOUT, env=F32)
    for r in res:
        assert abs(r["losses"][0] - losses[0]) < 1e-4 and abs(r["losses"][1] - losses[1]) < 1e-4
        assert r["counts"]["flash_fwd/ref"] == TP_CFG.n_layers
    want_loss, want_grads = _one_process_grads(TP_CFG, jparams, tokens)
    assert abs(res[0]["losses"][0] - want_loss) < 1e-4
    params = [r["params"] for r in res]
    grads = [r["grads"] for r in res]
    for path in params[0]:
        got = _tp_full(params, path, tp)
        np.testing.assert_allclose(got, _jax_leaf(new, path), rtol=1e-4, atol=1e-5,
                                   err_msg=path)
        g = _tp_full(grads, path, tp)
        _close(g, want_grads[path], 1e-4, f"grad {path}")
        if _replicated(path):
            for p in params[1:]:
                assert np.array_equal(p[path], params[0][path]), path


def _jax_single_steps(jcfg, jparams, tokens, lr, n):
    """JAX's one-device computation of n SGD steps (tests/test_sharding.py's
    oracle, :337-347): [losses], params."""
    from zgml_tpu.optim.sgd import sgd_update
    model, toks = JModel(jcfg, jparams), jnp.asarray(tokens, jnp.int32)
    b = tokens.shape[0]

    def loss_fn(params):
        logits, _ = model.forward(params, toks[:, :-1], model.init_cache(b), 0)
        logp = jax.nn.log_softmax(logits, axis=-1)
        return jnp.mean(-jnp.take_along_axis(logp, toks[:, 1:][..., None], axis=-1))
    params, losses = jparams, []
    for _ in range(n):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        params = sgd_update(params, grads, lr)
        losses.append(float(loss))
    return losses, params


@pytest.fixture(scope="module")
def pp_oracle():
    """PP_CFG's params (seed 7), [8, 10] tokens, JAX's two one-device SGD
    steps at lr 0.1 and the port's one-process loss and gradients, under the
    f32 flags."""
    with pytest.MonkeyPatch.context() as mp:
        _env(mp, F32)
        jparams = jax_init_params(PP_CFG, seed=7)
        tokens = np.random.default_rng(9).integers(0, 128, (8, 10))
        losses, new = _jax_single_steps(PP_CFG, jparams, tokens, 0.1, 2)
        want_loss, want_grads = _one_process_grads(PP_CFG, jparams, tokens)
    return jparams, tokens, losses, new, want_loss, want_grads


@pytest.mark.parametrize("n_micro", [4, None])
def test_pp_train_step_matches_jax(world, monkeypatch, pp_oracle, n_micro):
    """Two make_pp_train_step steps (pp 4, one layer a stage, tied lm_head)
    on [8, 10] tokens: the first loss within 1e-4 of JAX's make_pp_train_step,
    both losses and the params after them against JAX's one-device steps at
    JAX's rtol 1e-3 / atol 1e-4 (JAX's pipelined second step is not held:
    ROADMAP.md C, it moves tok_embd 1.9e-3 off its one-device step), the
    first step's gradients against the port's one-process ones (tok_embd's
    through both its paths, not pp times them), the replicated leaves the
    same bits on every stage."""
    _env(monkeypatch, F32)
    jparams, tokens, losses, new, want_loss, want_grads = pp_oracle
    mesh = jax_make_mesh(tp=4, dp=2, axis_names=("dp", "pp"))
    jmodel = JModel(PP_CFG, jparams)
    first, _ = jax_pp_step(jmodel, mesh, n_micro=n_micro)(
        jax_shard_pp(jparams, mesh), jnp.asarray(tokens, jnp.int32), jmodel.init_cache(8), 0.1)
    res = world.run(tasks.pp_train, _src(PP_CFG, jparams), n_micro, tokens, 0.1, 2,
                    timeout=WORLD_TIMEOUT, env=F32)
    per = PP_CFG.n_layers // 4
    for r in res:
        assert abs(r["losses"][0] - float(first)) < 1e-4
        assert abs(r["losses"][0] - losses[0]) < 1e-4 and abs(r["losses"][1] - losses[1]) < 1e-4
        assert abs(r["losses"][0] - want_loss) < 1e-4
        s = r["stage"]
        for path, got in r["params"].items():
            full = path
            if path.startswith("layers/"):
                _, li, name = path.split("/")
                full = f"layers/{s * per + int(li)}/{name}"
            _close(r["grads"][path], want_grads[full], 1e-4, f"grad {full}")
            np.testing.assert_allclose(got, _jax_leaf(new, full), rtol=1e-3, atol=1e-4,
                                       err_msg=full)
    for path in ("tok_embd", "out_norm"):
        for r in res[1:]:
            assert np.array_equal(r["params"][path], res[0]["params"][path]), path


def test_pp_stage_runs_its_layers_n_micro_times(world, monkeypatch):
    """The port's counterpart of test_pp_microbatch_flops_scale_down: with 8
    microbatches on 4 stages each stage runs its own layer 8 times (8 flash
    launches, 8 microbatches of its projections) and skips pp - 1 = 3
    bubble ticks, where a schedule that computed every tick would run 11;
    the logits match the one-process forward."""
    _env(monkeypatch, F32)
    jparams = jax_init_params(PP_CFG, seed=4)
    rng = np.random.default_rng(6)
    tokens, steps = rng.integers(0, 128, (8, 6)), rng.integers(0, 128, (8, 1))
    res = world.run(tasks.pp_forward, _src(PP_CFG, jparams), 8, tokens, steps, "bf16",
                    timeout=WORLD_TIMEOUT, env=F32)
    for r in res:
        assert r["ticks"] == {"pp_stage_runs": 8, "pp_bubble_ticks": 3}
        assert r["counts"]["attention/ref"] == 8
    cfg = LlamaConfig(**dataclasses.asdict(PP_CFG))
    model = LlamaModel(cfg, params_from_jax(_np(jparams), cfg, device="cpu"))
    with torch.inference_mode():
        want = model(torch.as_tensor(tokens), model.init_cache(8), 0).numpy()
    for r in res:
        _close(r["prefill"], want, 1e-5, "prefill logits")


@pytest.mark.parametrize("cache_dtype", ["bf16", "f32"])
def test_pp_forward_matches_jax(world, monkeypatch, cache_dtype):
    """make_pp_forward (pp 4, the default n_micro) against JAX's on [2, 6]
    tokens then one decode token: logits and every stage's cache slab within
    1e-5 of max (the bf16 cache: or one bf16 ulp), over the bf16 and the f32
    cache."""
    _env(monkeypatch, F32)
    jcfg = dataclasses.replace(PP_CFG, n_layers=8, tied_lm_head=False)
    jparams = jax_init_params(jcfg, seed=4)
    rng = np.random.default_rng(5)
    tokens, steps = rng.integers(0, 128, (2, 6)), rng.integers(0, 128, (2, 1))
    mesh = jax_make_mesh(tp=4, dp=2, axis_names=("dp", "pp"))
    jmodel = JModel(jcfg, jparams)
    fwd = jax_pp_forward(jmodel, mesh)
    sharded = jax_shard_pp(jparams, mesh)
    cache = jmodel.init_cache(2, jnp.float32 if cache_dtype == "f32" else jnp.bfloat16)
    want, cache = fwd(sharded, jnp.asarray(tokens, jnp.int32), cache, 0)
    want_step, cache = fwd(sharded, jnp.asarray(steps, jnp.int32), cache, 6)
    res = world.run(tasks.pp_forward, _src(jcfg, jparams), None, tokens, steps, cache_dtype,
                    timeout=WORLD_TIMEOUT, env=F32)
    per = jcfg.n_layers // 4
    for r in res:
        _close(r["prefill"], np.asarray(want), 1e-5, "prefill")
        _close(r["decode"], np.asarray(want_step), 1e-5, "decode")
        s = r["stage"]
        for name in ("k", "v"):
            jc = np.asarray(cache[name][s * per:(s + 1) * per, :, :, :7]).astype(np.float32)
            if cache_dtype == "f32":
                _close(r["cache"][name], jc, 1e-5, f"stage {s} cache {name}")
            else:       # a K value's f32 sums may round to bf16 either side of a tie
                ulp = np.ldexp(1.0, np.frexp(np.abs(jc))[1] - 8)
                bound = np.maximum(ulp, 1e-5 * np.abs(jc).max())
                assert (np.abs(r["cache"][name] - jc) <= bound).all(), f"stage {s} {name}"


@pytest.mark.parametrize("batch", range(1, 17))
@pytest.mark.parametrize("pp", [1, 2, 4])
def test_choose_micro_matches_jax(batch, pp):
    assert _choose_micro(batch, pp) == jax_choose_micro(batch, pp)


def test_refusals(world):
    """JAX's refusals, with its meaning: n_layers % pp, batch % n_micro,
    params never sharded; and a quantized model, which JAX's steps refuse
    (their gradient of int8 leaves, their scan over a loaded model)."""
    jparams = jax_init_params(PP_CFG, seed=1)
    odd = dataclasses.replace(PP_CFG, n_layers=6)
    res = world.run(tasks.pp_refusals, {"layers": _src(odd, jax_init_params(odd, seed=1)),
                                        "unsharded": _src(PP_CFG, jparams),
                                        "batch": _src(PP_CFG, jparams),
                                        "quantized": ("zeros", LlamaConfig(
                                            **dataclasses.asdict(PP_CFG)), "q8_0"),
                                        "tp_quantized": ("zeros", LlamaConfig(
                                            **dataclasses.asdict(TP_CFG)), "q8_0")},
                    timeout=WORLD_TIMEOUT)
    for r in res:
        assert "not divisible by pp=4" in r["layers"]
        assert "run shard_pp_params" in r["unsharded"]
        assert "not divisible by n_micro=3" in r["batch"]
        assert "dense float params" in r["quantized"]
        assert "dense float params" in r["tp_quantized"]
