"""Parameter trees: a tensor, or a dict (nested or flat) of them.

The geometry stage optimises one tensor (tet_v), the texture stage a
material's dict ({"encoding": {"table"}, "network": {"l0_w", ...}}). The
leaves are visited in ``jax.tree_util`` order, dict keys sorted, so the
optimisers see them in the order the JAX package does.
"""

from __future__ import annotations

from typing import Any, Callable, List

import torch


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The leaves, dict keys sorted at every level."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(tree: Any, leaves: List[torch.Tensor]) -> Any:
    """``tree``'s structure with ``leaves`` (in ``tree_leaves`` order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def leaf_names(tree: Any, prefix: str = "") -> List[str]:
    """Each leaf's path as JAX's ``tree_leaves_with_path`` prints it,
    ``"['encoding']/['table']"``: the key names of ``material.npz``."""
    if isinstance(tree, dict):
        return [name for k in sorted(tree)
                for name in leaf_names(tree[k], f"{prefix}/['{k}']"
                                       if prefix else f"['{k}']")]
    return [prefix]
