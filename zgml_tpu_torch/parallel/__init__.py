"""Multi-rank inference of the llama model on torch.distributed: the (dp, tp)
mesh, tensor parallelism, ring attention, context-parallel prefill
(counterpart of zgml_tpu/parallel, its serving half)."""
from zgml_tpu_torch.parallel.mesh import init_distributed, make_mesh  # noqa: F401
from zgml_tpu_torch.parallel.tp import make_sharded_forward, shard_llama_params  # noqa: F401
