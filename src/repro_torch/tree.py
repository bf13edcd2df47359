"""Pytree helpers with ``jax.tree_util``'s conventions, for nested dicts,
lists and tuples of tensors: dicts are walked (and rebuilt) in sorted-key
order, lists and tuples by index, ``None`` is an empty subtree, anything
else is a leaf. ``map_dicts`` alone keeps each dict's own key order.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def leaves_with_path(tree: Any, path: Tuple[str, ...] = ()
                     ) -> List[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in leaves_with_path(tree[k], path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in leaves_with_path(v, path + (str(i),))]
    return [] if tree is None else [(path, tree)]


def tree_leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over corresponding leaves of trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return None if tree is None else fn(tree, *rest)


def map_dicts(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` over the leaves of nested dicts, keeping their key order."""
    if isinstance(tree, dict):
        return {k: map_dicts(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` in leaf order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
