"""A multi-rank dry run of the parallel paths on tiny shapes.

zgml_tpu's dryrun_multichip (__graft_entry__.py:48-175):
``dryrun_multichip(n, device)`` spawns n ranks (parallel/world.World,
init_method file://) and runs on them, in its training half, one dp + tp
train step of a dense model over a (dp, tp) mesh (:75-79) and one GPipe
train step of a tied-head dense model over a 'pp' axis of all n ranks, one
layer a stage, four microbatches (:90-104); in its serving half one TP
forward of the stepped model, one TP decode token of a Q4_0 model through
K7 on local heads, one context-parallel prefill (ring attention over a 'cp'
axis of all n ranks) with a decode step after it, and one request served
over the mesh. Run it on the card with NCCL (the default), or on the CPU with
backend="gloo" and device="cpu":

    python -m zgml_tpu_torch.parallel.dryrun 4 cpu gloo
"""
from __future__ import annotations

import pathlib
import sys
import tempfile

import numpy as np
import torch


def _dryrun_rank(dev: torch.device, n: int, gguf: str) -> dict:
    from zgml_tpu_torch.io.llama_loader import load_llama
    from zgml_tpu_torch.models.llama import LlamaConfig, LlamaModel, init_params
    from zgml_tpu_torch.parallel import (make_mesh, make_pp_train_step, make_sharded_forward,
                                         make_sharded_train_step, shard_llama_params,
                                         shard_pp_params)
    from zgml_tpu_torch.runtime.engine import LlamaEngine
    from zgml_tpu_torch.runtime.profile import global_profile
    from zgml_tpu_torch.runtime.serving import ContinuousBatchingEngine
    out = {}
    tp = next(c for c in (8, 4, 2, 1) if n % c == 0)      # JAX's dryrun's mesh
    dp = n // tp
    mesh = make_mesh(tp=tp, dp=dp, device=dev)
    cfg = LlamaConfig(vocab_size=256, d_model=64, n_heads=8, n_kv_heads=8, d_ff=128,
                      n_layers=2, max_seq_len=32)
    model = LlamaModel(cfg, init_params(cfg, seed=0, device="cpu"))
    shard_llama_params(model, mesh)
    tokens = np.random.default_rng(0).integers(0, 256, (2 * dp, 9))
    mine = torch.as_tensor(tokens[mesh.coords["dp"] * 2:(mesh.coords["dp"] + 1) * 2])
    # the full dp + tp training step, then the forward on the stepped params
    loss, _ = make_sharded_train_step(model, mesh)(mine, 1e-2)
    if not bool(torch.isfinite(loss)):
        raise RuntimeError("training loss not finite")
    out["train_loss"] = float(loss)
    # a GPipe training step over a 'pp' axis of all n ranks, tied lm_head
    pp_mesh = make_mesh(tp=n, dp=1, axis_names=("dp", "pp"), device=dev)
    pp_cfg = LlamaConfig(vocab_size=256, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                         n_layers=n, max_seq_len=32, tied_lm_head=True)
    pp_model = LlamaModel(pp_cfg, init_params(pp_cfg, seed=1, device="cpu"))
    shard_pp_params(pp_model, pp_mesh)
    pp_tokens = torch.as_tensor(np.random.default_rng(1).integers(0, 256, (4, 9)))
    pp_loss, _ = make_pp_train_step(pp_model, pp_mesh, n_micro=4)(pp_tokens, 1e-2)
    if not bool(torch.isfinite(pp_loss)):
        raise RuntimeError("pp training loss not finite")
    out["pp_loss"] = float(pp_loss)

    fwd = make_sharded_forward(model, mesh)
    logits = fwd(mine[:, :1], model.init_cache(2), 0)
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("TP forward logits not finite")
    out["tp_forward"] = tuple(logits.shape)

    # TP decode through K7 on the local heads of a Q4_0 model
    tp2 = 2 if n % 2 == 0 else 1
    q_mesh = make_mesh(tp=tp2, dp=n // tp2, device=dev)
    q_model, gf = load_llama(gguf, device="cpu")
    gf.close()
    shard_llama_params(q_model, q_mesh)
    q_fwd = make_sharded_forward(q_model, q_mesh)
    q_cache = q_model.init_cache(1)
    prompt = torch.as_tensor(np.random.default_rng(3).integers(0, 256, (1, 6)))
    q_fwd(prompt, q_cache, 0)
    global_profile.reset()
    q_logits = q_fwd(torch.tensor([[7]]), q_cache, 6)
    k7 = sum(v for (op, _), v in global_profile.op_tiers.items() if op.startswith("attn_block"))
    if not bool(torch.isfinite(q_logits).all()) or k7 == 0:
        raise RuntimeError(f"TP decode through K7: finite {bool(torch.isfinite(q_logits).all())}"
                           f", K7 calls {k7}")
    out["tp_decode_k7_calls"] = k7

    # context-parallel prefill: ring attention over all n ranks
    cp_mesh = make_mesh(tp=n, dp=1, axis_names=("dp", "cp"), device=dev)
    cp_cfg = LlamaConfig(vocab_size=256, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                         n_layers=2, max_seq_len=128)
    cp_model = LlamaModel(cp_cfg, init_params(cp_cfg, seed=2, device=dev))
    eng = LlamaEngine(cp_model)
    global_profile.reset()
    last = eng.prefill_cp(np.random.default_rng(2).integers(0, 256, 96), cp_mesh)
    eng.step(torch.argmax(last, dim=-1))
    out["cp_ring_calls"] = sum(v for (op, _), v in global_profile.op_tiers.items()
                               if op == "ring_attention")
    if not bool(torch.isfinite(last).all()) or out["cp_ring_calls"] == 0:
        raise RuntimeError(f"context-parallel prefill: finite {bool(torch.isfinite(last).all())}"
                           f", ring calls {out['cp_ring_calls']}")

    # one request served over the (dp, tp) mesh of the Q4_0 model
    serve = ContinuousBatchingEngine(q_model, max_batch=q_mesh.shape["dp"], prefill_chunk=8,
                                     mesh=q_mesh)
    out["served"] = serve.run([([1, 2, 3], 4)])[0]
    return out


def dryrun_multichip(n: int, device: str = "cuda", backend: str = "nccl",
                     timeout: float = 300.0) -> dict:
    """Run the dry run on n spawned ranks; returns rank 0's summary and
    raises if any rank fails or does not answer within `timeout` seconds."""
    from zgml_tpu_torch.io.gguf import GGMLType
    from zgml_tpu_torch.models.llama import LlamaConfig
    from zgml_tpu_torch.parallel.world import World
    from zgml_tpu_torch.utils.synthetic import write_synthetic_llama_gguf
    q_cfg = LlamaConfig(vocab_size=256, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
                        n_layers=2, max_seq_len=64)
    with tempfile.TemporaryDirectory(prefix="zgml_dryrun_") as tmp:
        gguf = str(pathlib.Path(tmp, "q4.gguf"))
        write_synthetic_llama_gguf(gguf, q_cfg, GGMLType.Q4_0, seed=9)
        with World(n, backend=backend, device=device) as world:
            results = world.run(_dryrun_rank, n, gguf, timeout=timeout)
    if any(r["served"] != results[0]["served"] for r in results):
        raise RuntimeError(f"ranks disagree on the served stream: {results}")
    return results[0]


if __name__ == "__main__":
    args = sys.argv[1:]
    summary = dryrun_multichip(int(args[0]) if args else 2, *args[1:3])
    print(f"dryrun_multichip ok: {summary}")
