"""ContinuousBatchingEngine(mesh=...) on the CPU: the port's mesh server in
gloo worlds of 4 ranks (dp 2 x tp 2) and 2 ranks (tp 2 alone, dp 2 alone)
against the JAX package's mesh server and the port's one-process server.

Every server runs over the same synthetic file (TINY_TEST at Q8_0, seed 9,
loaded dense by each package, as tests/test_serving.py loads it), greedy:
  - dp 2 x tp 2 and tp 2: each stream equal to the JAX mesh server's over
    the bf16 cache (mirrors of test_mesh_serving_matches_single and
    test_mesh_serving_burst_and_slot_reuse);
  - dp 2 x tp 1: each stream equal to the port's one-process server of the
    local max_batch (max_batch / dp rows, the same function a row at a time);
    sampled (temperature > 0), equal to the one-process server of the whole
    max_batch from the same seed;
  - dryrun_multichip(4, "cpu", "gloo") once, both halves.
"""
import jax
import pytest

import torch_parallel_tasks as tasks
from zgml_tpu.io.llama_loader import load_llama as jax_load_llama
from zgml_tpu.models.llama import LlamaModel as JModel
from zgml_tpu.parallel import make_mesh as jax_make_mesh
from zgml_tpu.parallel.tp import shard_llama_params_fused
from zgml_tpu.runtime.serving import ContinuousBatchingEngine as JaxServer

from zgml_tpu_torch.io.gguf import GGMLType
from zgml_tpu_torch.parallel.dryrun import dryrun_multichip
from zgml_tpu_torch.parallel.world import World
from zgml_tpu_torch.runtime.sampling import SamplingParams
from zgml_tpu_torch.runtime.serving import ContinuousBatchingEngine
from zgml_tpu_torch.utils.synthetic import TINY_TEST, write_synthetic_llama_gguf

WORLD_TIMEOUT = 120


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("serve_mesh") / "t.gguf")
    write_synthetic_llama_gguf(path, TINY_TEST, GGMLType.Q8_0, seed=9)
    return path


@pytest.fixture(scope="module")
def world4():
    with World(4, backend="gloo", device="cpu") as w:
        yield w


@pytest.fixture(scope="module")
def world2():
    with World(2, backend="gloo", device="cpu") as w:
        yield w


def _jax_mesh_streams(path, tp, dp, max_batch, requests, burst=1):
    jm, gf = jax_load_llama(path, mode="dense")
    gf.close()
    mesh = jax_make_mesh(tp=tp, dp=dp, devices=jax.devices()[:tp * dp])
    serve = JaxServer(JModel(jm.cfg, shard_llama_params_fused(jm, mesh)), max_batch=max_batch,
                      mesh=mesh)
    outs = serve.run(requests, burst=burst)
    return [outs[r] for r in sorted(outs)]


def _port_streams(world, path, tp, dp, max_batch, requests, burst=1, sampling=SamplingParams()):
    res = world.run(tasks.serve, ("gguf", path, "dense"), tp, dp, max_batch, requests, burst,
                    sampling, timeout=WORLD_TIMEOUT)
    assert all(r == res[0] for r in res), res      # every rank's host state is the same
    return [res[0][r] for r in sorted(res[0])]


def test_mesh_serving_matches_jax(world4, gguf):
    """dp 2 x tp 2, 4 slots (2 a dp rank), 4 requests of 6 tokens."""
    reqs = [([1, 2, 3], 6), ([10, 20, 30, 40], 6), ([7], 6), ([9, 8], 6)]
    assert _port_streams(world4, gguf, 2, 2, 4, reqs) == _jax_mesh_streams(gguf, 2, 2, 4, reqs)


def test_mesh_serving_burst_and_slot_reuse(world2, gguf):
    """tp 2 alone: 5 requests through 2 slots, decoded in bursts of 4."""
    reqs = [([i + 1, i + 2, i + 3], 4) for i in range(5)]
    assert (_port_streams(world2, gguf, 2, 1, 2, reqs, burst=4)
            == _jax_mesh_streams(gguf, 2, 1, 2, reqs, burst=4))


def test_dp_serving_equals_one_process_server(world2, gguf):
    """dp 2 x tp 1, 4 slots: each stream equal to the port's one-process
    server of 2 slots (slot reuse, a burst and a mid-prefill admission on
    both)."""
    reqs = [([i + 1, 2 * i + 1, 7], 5 + i % 3) for i in range(6)] + [(list(range(1, 40)), 4)]
    got = _port_streams(world2, gguf, 1, 2, 4, reqs, burst=4)
    model = tasks.build_model(("gguf", gguf, "dense"))
    outs = ContinuousBatchingEngine(model, max_batch=2).run(reqs, burst=4)
    assert got == [outs[r] for r in sorted(outs)]


@pytest.mark.parametrize("burst", [1, 4])
def test_dp_sampled_serving_equals_one_process_server(world2, gguf, burst):
    """dp 2 x tp 1, 4 slots, temperature 0.9 with top-k 8: each stream equal
    to the port's one-process server of all 4 slots from the same seed. The
    mesh draws for the global batch on every rank, so the rows of the two dp
    ranks do not share random numbers (a rank seeded alike that drew for its
    own rows alone would give row j of each rank the same draws)."""
    reqs = [([i + 1, 2 * i + 1, 7], 6 + i % 3) for i in range(6)]
    params = SamplingParams(temperature=0.9, top_k=8)
    got = _port_streams(world2, gguf, 1, 2, 4, reqs, burst=burst, sampling=params)
    model = tasks.build_model(("gguf", gguf, "dense"))
    outs = ContinuousBatchingEngine(model, max_batch=4, sampling=params).run(reqs, burst=burst)
    want = [outs[r] for r in sorted(outs)]
    assert got == want
    greedy = ContinuousBatchingEngine(model, max_batch=4).run(reqs, burst=burst)
    assert want != [greedy[r] for r in sorted(greedy)]      # the draws decide tokens


def test_dryrun_multichip_cpu(monkeypatch):
    """The dry run on 4 spawned gloo ranks (which inherit the flags): its
    training half, the dp + tp train step and the GPipe step over 4 stages,
    whose losses are JAX's dry run's (__graft_entry__.py:64-104: the same
    configs, seeds and tokens) within 1e-4 at ZGML_TPU_PREFILL_BF16=0; and
    its serving half (TP forward, TP decode through K7, CP prefill, a mesh
    request)."""
    import jax.numpy as jnp
    import numpy as np

    from zgml_tpu.models.llama import LlamaConfig as JCfg
    from zgml_tpu.models.llama import init_params as jax_init_params
    from zgml_tpu.parallel import make_sharded_train_step, shard_llama_params
    from zgml_tpu.parallel.pp import make_pp_train_step, shard_pp_params
    monkeypatch.setenv("ZGML_TPU_PREFILL_BF16", "0")
    monkeypatch.setenv("ZGML_TPU_SCALES", "f16")
    cfg = JCfg(vocab_size=256, d_model=64, n_heads=8, n_kv_heads=8, d_ff=128, n_layers=2,
               max_seq_len=32)
    model = JModel(cfg, jax_init_params(cfg, seed=0))
    mesh = jax_make_mesh(tp=4, dp=1, devices=jax.devices()[:4])
    tokens = jnp.asarray(np.random.default_rng(0).integers(0, 256, (2, 9)), jnp.int32)
    loss, _ = make_sharded_train_step(model, mesh)(shard_llama_params(model.params, mesh), tokens,
                                                   model.init_cache(2), 1e-2)
    pp_cfg = JCfg(vocab_size=256, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, n_layers=4,
                  max_seq_len=32, tied_lm_head=True)
    pp_model = JModel(pp_cfg, jax_init_params(pp_cfg, seed=1))
    pp_mesh = jax_make_mesh(tp=4, dp=1, devices=jax.devices()[:4], axis_names=("dp", "pp"))
    pp_tokens = jnp.asarray(np.random.default_rng(1).integers(0, 256, (4, 9)), jnp.int32)
    pp_loss, _ = make_pp_train_step(pp_model, pp_mesh, n_micro=4)(
        shard_pp_params(pp_model.params, pp_mesh), pp_tokens, pp_model.init_cache(4), 1e-2)
    out = dryrun_multichip(4, "cpu", "gloo", timeout=WORLD_TIMEOUT)
    assert abs(out["train_loss"] - float(loss)) < 1e-4
    assert abs(out["pp_loss"] - float(pp_loss)) < 1e-4
    assert out["tp_decode_k7_calls"] > 0 and out["cp_ring_calls"] > 0
    assert len(out["served"]) == 4
