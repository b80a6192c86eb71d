"""Multi-rank inference and training of the llama model on torch.distributed:
the (dp, tp) mesh, tensor parallelism and its train step, ring attention,
context-parallel prefill, and the GPipe pipeline over a 'pp' axis
(counterpart of zgml_tpu/parallel)."""
from zgml_tpu_torch.parallel.mesh import init_distributed, make_mesh  # noqa: F401
from zgml_tpu_torch.parallel.pp import (make_pp_forward, make_pp_train_step,  # noqa: F401
                                        shard_pp_params)
from zgml_tpu_torch.parallel.tp import (make_sharded_forward,  # noqa: F401
                                        make_sharded_train_step, shard_llama_params)
