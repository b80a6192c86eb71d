"""The lazy graph tier: LazyTensor IR, fusion pass, lowering to torch, autograd."""
from zgml_tpu_torch.graph.tensor import LazyTensor, var, const  # noqa: F401
from zgml_tpu_torch.graph.graph import ComputeGraph  # noqa: F401
from zgml_tpu_torch.graph.op import Op  # noqa: F401
