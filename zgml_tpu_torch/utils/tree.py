"""Trees of tensors: nested dicts, lists and tuples with tensor leaves.

The port's stand-in for the JAX pytree functions the training code uses.
Dicts are walked in sorted key order, as jax.tree_util walks them, so a
leaf's '/'-joined path (dict keys, list indices) names it as the JAX
package's checkpoints do (zgml_tpu/io/checkpoint.py _flatten).
"""
from __future__ import annotations

from typing import Any, Callable


def flatten(tree: Any) -> tuple[list, Callable[[list], Any]]:
    """(leaves, rebuild): rebuild(new_leaves) gives the tree back with the
    leaves replaced in order."""
    leaves: list = []

    def walk(t):
        if isinstance(t, dict):
            keys = sorted(t)
            subs = [walk(t[k]) for k in keys]
            return lambda it: {k: s(it) for k, s in zip(keys, subs)}
        if isinstance(t, (list, tuple)):
            subs = [walk(x) for x in t]
            kind = type(t)
            return lambda it: kind(s(it) for s in subs)
        leaves.append(t)
        return lambda it: next(it)

    build = walk(tree)
    return leaves, lambda new: build(iter(new))


def paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """[(path, leaf)] in flatten's order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [p for i, x in enumerate(tree) for p in paths(x, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """fn over the leaves of `tree` and the matching leaves of `rest`."""
    leaves, rebuild = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    return rebuild([fn(*args) for args in zip(leaves, *others)])
