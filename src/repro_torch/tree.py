"""Nested dict/list/tuple trees of tensors, as the port's params are.

The few ``jax.tree_util`` operations the port needs (the int8 export,
the LM's layer slices, the optimizers, checkpoints).  Leaves come in
``jax.tree_util``'s order (dict keys sorted), and a leaf's path is its
dict keys and list indices from the root, so a path names the same leaf
in both packages' trees.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def leaves_with_paths(tree: Any, path: tuple = ()
                      ) -> Iterator[Tuple[tuple, Any]]:
    """(path, leaf) pairs in ``jax.tree_util`` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, path + (i,))
    else:
        yield path, tree


def tree_leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree of ``rest`` (same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten_like(template: Any, leaves: List[Any]) -> Any:
    """The tree of ``template``'s structure holding ``leaves`` in
    :func:`leaves_with_paths` order."""
    it = iter(leaves)
    order = {path: next(it) for path, _ in leaves_with_paths(template)}
    return tree_map_with_path(lambda path, _: order[path], template)


def tree_map_with_path(fn: Callable, tree: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf)`` over the leaves of ``tree``."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)
