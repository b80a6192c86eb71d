"""ComputeGraph: topo ordering, fusion, lowering to torch, autodiff.

Counterpart of zgml_tpu/graph/graph.py:23-209. Graph capture -> topo order ->
fusion pass -> one lowered eager function; PyTorch runs it as it is (no jit,
no torch.compile), and autograd differentiates it (``grad``,
``value_and_grad``: torch.autograd.grad on leaf copies of the named feeds).

Every fused chain (graph/fusion.py) is one launch of K13, the fused
elementwise kernel (ops/dispatch.fused_chain), on the card (consecutive
launches past 16 steps or 8 side inputs); its plain composition on the CPU
and under dispatch.force_ref(). Under ZGML_TPU_KERNELS=ref (config.kernel_on
with no name, as the JAX package's use_pallas(), graph.py:129-130) a chain
runs step by step, node by node, read at each run. The graph runs on the
card unless built with device="cpu"; without a card the default raises.

The chain's operand order is the graph's: where the chain value is the right
operand of a binary step (``y.sub(x.exp())``), the step is side - chain. The
JAX package's `_emit_chain` computes chain - side there (graph.py:116-124
with elementwise.py:96-101), which its own ``fuse=False`` lowering does not;
the port computes the graph's function, as JAX's fuse=False does (ROADMAP,
Reference weak spots).
"""
from __future__ import annotations

from collections import Counter
from typing import Any, Sequence

import torch

from zgml_tpu_torch import config
from zgml_tpu_torch.graph.fusion import FusionReport, detect_chains
from zgml_tpu_torch.graph.lower import BINARY_OPS, as_tensor, lower_node
from zgml_tpu_torch.graph.op import Op
from zgml_tpu_torch.graph.tensor import LazyTensor
from zgml_tpu_torch.ops import dispatch
from zgml_tpu_torch.ops.elementwise import MAX_SIDES, MAX_STEPS, Step
from zgml_tpu_torch.quant.packed import resolve_device


def topo_order(outputs: Sequence[LazyTensor]) -> list[LazyTensor]:
    """Parents-then-self DFS with a visited set."""
    seen: set[int] = set()
    order: list[LazyTensor] = []

    def visit(n: LazyTensor):
        if n.id in seen:
            return
        seen.add(n.id)
        for s in n.srcs:
            visit(s)
        order.append(n)

    for o in outputs:
        visit(o)
    return order


class ComputeGraph:
    """Build once, execute many times. ``device``: where the graph runs (the
    card unless "cpu")."""

    def __init__(self, outputs: LazyTensor | Sequence[LazyTensor], fuse: bool = True,
                 device=None):
        self.device = resolve_device("cuda" if device is None else device)
        self.outputs = ([outputs] if isinstance(outputs, LazyTensor) else list(outputs))
        self.order = topo_order(self.outputs)
        self.vars = [n for n in self.order if n.op == Op.VAR]
        self.fusion: FusionReport | None = None
        if fuse:
            self.fusion = detect_chains(self.order, {o.id for o in self.outputs})
        self._fn = None

    # -- lowering ------------------------------------------------------------
    def _build_fn(self):
        order = self.order
        chains = self.fusion.chains if self.fusion else []
        # a chain is emitted at its output node, which comes after every side
        # input in topo order (the JAX package emits it at its head, where a
        # side input computed later is not there yet: a KeyError)
        chain_by_output: dict[int, Any] = {c.output.id: c for c in chains if len(c.nodes) >= 2}
        interior = {n.id for c in chain_by_output.values() for n in c.nodes[:-1]}
        var_names = [v.name for v in self.vars]
        device = self.device

        def fn(*args):
            if len(args) != len(var_names):
                raise TypeError(f"expected {len(var_names)} args ({var_names}), got {len(args)}")
            vals: dict[int, Any] = {v.id: as_tensor(a, device) for v, a in zip(self.vars, args)}
            fused = config.kernel_on()        # ZGML_TPU_KERNELS=ref: node by node
            for node in order:
                if node.op == Op.VAR:
                    continue
                if fused and node.id in interior:
                    continue          # computed as part of its chain
                chain = chain_by_output.get(node.id) if fused else None
                vals[node.id] = (self._emit_chain(chain, vals) if chain is not None
                                 else lower_node(node, vals, device))
            outs = [vals[o.id] for o in self.outputs]
            return outs[0] if len(outs) == 1 else tuple(outs)

        return fn

    @staticmethod
    def _emit_chain(chain, vals):
        """One fused chain as K13's steps: the head's first source is the
        chain input (broadcast to the head's shape), every binary step takes
        its other operand as a side input and records whether that side input
        is the left operand. A chain longer than one launch takes (MAX_STEPS
        steps, MAX_SIDES side inputs) runs as consecutive launches."""
        head = chain.nodes[0]
        x = vals[head.srcs[0].id]
        if tuple(x.shape) != tuple(head.shape):
            x = torch.broadcast_to(x, head.shape)
        steps, sides = [], []
        prev_id = None
        for node in chain.nodes:
            binary = node.op in BINARY_OPS
            if len(steps) == MAX_STEPS or (binary and len(sides) == MAX_SIDES):
                x, steps, sides = dispatch.fused_chain(x, steps, sides), [], []
            if binary:
                if prev_id is None:           # head binary: the second operand is the side
                    other, side_left = node.srcs[1], False
                else:
                    other = next(s for s in node.srcs if s.id != prev_id)
                    side_left = node.srcs[0].id != prev_id
                steps.append(Step(node.op.value, side=len(sides), side_left=side_left))
                sides.append(vals[other.id])
            else:
                payload = node.payload if node.op in (Op.SCALE, Op.ADD_SCALAR) else 0.0
                steps.append(Step(node.op.value, payload=payload))
            prev_id = node.id
        return dispatch.fused_chain(x, steps, sides)

    # -- public api ----------------------------------------------------------
    def compile(self):
        """The lowered function of the vars in graph order (eager torch)."""
        if self._fn is None:
            self._fn = self._build_fn()
        return self._fn

    def _args(self, feeds: dict) -> list[torch.Tensor]:
        return [as_tensor(feeds[v.name], self.device) for v in self.vars]

    def run(self, **feeds):
        """Execute forward with named var bindings (numpy arrays or tensors)."""
        with torch.no_grad():
            return self.compile()(*self._args(feeds))

    def _grad_call(self, wrt: Sequence[str], feeds: dict):
        fn = self.compile()
        want = set(wrt)
        args = self._args(feeds)
        names, leaves = [], []
        for i, v in enumerate(self.vars):
            if v.name in want:
                args[i] = args[i].detach().clone().requires_grad_()
                names.append(v.name)
                leaves.append(args[i])
        out = fn(*args)
        val = out[0] if isinstance(out, tuple) else out
        gs = torch.autograd.grad(val, leaves, allow_unused=True)
        grads = {n: torch.zeros_like(t) if g is None else g for n, t, g in zip(names, leaves, gs)}
        return val.detach(), grads

    def grad(self, wrt: Sequence[str]):
        """Gradient function of the (scalar) first output with respect to the
        named vars: grad_fn(**feeds) -> {name: gradient}."""
        def grad_fn(**feeds):
            return self._grad_call(wrt, feeds)[1]
        return grad_fn

    def value_and_grad(self, wrt: Sequence[str]):
        """fn(**feeds) -> (first output, {name: gradient})."""
        def fn(**feeds):
            return self._grad_call(wrt, feeds)
        return fn

    # -- diagnostics ---------------------------------------------------------
    def report(self) -> str:
        """Node census + fusion report."""
        ops = Counter(n.op.value for n in self.order)
        lines = [f"== graph: {len(self.order)} nodes, "
                 f"{len(self.vars)} vars, {len(self.outputs)} outputs =="]
        for op, cnt in ops.most_common():
            lines.append(f"  {op:<16} x{cnt}")
        if self.fusion:
            lines.append(self.fusion.render())
        return "\n".join(lines)

    def to_dot(self) -> str:
        """GraphViz export."""
        lines = ["digraph G {", "  rankdir=BT;"]
        for n in self.order:
            label = n.op.value + (f"\\n{n.name}" if n.name else "") + f"\\n{n.shape}"
            shape = "box" if n.op in (Op.VAR, Op.CONST) else "ellipse"
            lines.append(f'  n{n.id} [label="{label}", shape={shape}];')
            for s in n.srcs:
                lines.append(f"  n{s.id} -> n{n.id};")
        lines.append("}")
        return "\n".join(lines)
